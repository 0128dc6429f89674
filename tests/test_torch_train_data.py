"""Parity: the port's data and selection helpers vs svtpu's, on the CPU —
identical arrays for the same seeds."""
import numpy as np
import pytest

from svtpu.config import BUILTIN_VIDEOS as JAX_VIDEOS
from svtpu.data import datasets as jd
from svtpu.data.pairs import build_pairs as jax_build_pairs
from svtpu.data.pairs import epoch_batches as jax_epoch_batches
from svtpu.data.segments import split_segments as jax_split
from svtpu.evaluation import hamming as jh
from svtpu.training.trainer import modal_consistency as jax_modal_consistency
from svtpu_torch.config import BUILTIN_VIDEOS, VideoMeta
from svtpu_torch.data import datasets as td
from svtpu_torch.data import native
from svtpu_torch.data.pairs import build_pairs, epoch_batches
from svtpu_torch.data.segments import split_segments
from svtpu_torch.evaluation import hamming as th
from svtpu_torch.training.trainer import modal_consistency

from _torch_port import ArrayStore


@pytest.fixture(scope="module")
def synth_video(tmp_path_factory):
    """60 frames, states [0,20), [20,40), [40,60): R/G/B blocks."""
    from PIL import Image

    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i in range(60):
        base = np.zeros((32, 32, 3), np.uint8)
        base[..., i // 20] = 200
        img = np.clip(base + rng.integers(0, 30, base.shape), 0,
                      255).astype(np.uint8)
        Image.fromarray(img).save(d / f"{i:010d}.jpg")
    return d, VideoMeta("synth", flags=(20, 40), last_frame=59, grey_out=1)


@pytest.mark.parametrize("video", sorted(BUILTIN_VIDEOS))
def test_split_segments_matches_jax(video):
    segs = BUILTIN_VIDEOS[video].state_segments()
    assert segs == JAX_VIDEOS[video].state_segments()
    for pcts in ((0.1, 0.1), (0.15, 0.15), (0.0, 0.2)):
        _assert_same_split(split_segments(segs, *pcts),
                           jax_split(segs, *pcts))


def _assert_same_split(ours, ref):
    for mode in ("train", "val", "test"):
        assert ours.of(mode) == ref.of(mode), mode


def test_build_pairs_and_epoch_batches_match_jax():
    splits = split_segments(BUILTIN_VIDEOS["chinese_chess"].state_segments(),
                            0.1, 0.1)
    for seed in (0, 7):
        table = build_pairs(splits.train, seed)
        np.testing.assert_array_equal(table,
                                      jax_build_pairs(splits.train, seed))
        for bs, shuffle in ((32, True), (7, False)):
            np.testing.assert_array_equal(
                epoch_batches(table, bs, seed + 3, shuffle=shuffle),
                jax_epoch_batches(table, bs, seed + 3, shuffle=shuffle))


def test_pair_and_segment_batchers_match_jax():
    meta = BUILTIN_VIDEOS["chinese_chess"]
    splits = split_segments(meta.state_segments(), 0.1, 0.1)
    store = ArrayStore(np.random.default_rng(1).integers(
        0, 256, (480, 4, 4, 3), np.uint8))
    for split, shuffle in ((splits.train, True), (splits.val, False)):
        ours = td.PairBatcher(store, split, 32, seed=5, shuffle=shuffle)
        ref = jd.PairBatcher(store, split, 32, seed=5, shuffle=shuffle)
        assert ours.num_batches() == ref.num_batches()
        for epoch in (0, 3):
            for a, b in zip(ours.epoch_indices(epoch),
                            ref.epoch_indices(epoch), strict=True):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype == np.int32
            for a, b in zip(ours.epoch(epoch), ref.epoch(epoch), strict=True):
                np.testing.assert_array_equal(a, b)
    segs = meta.state_segments()
    for a, b in zip(td.SegmentBatcher(store, segs, seed=2).epoch(1),
                    jd.SegmentBatcher(store, segs, seed=2).epoch(1),
                    strict=True):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for a, b in zip(td.RandomPairBatcher(store, segs, 8, 20, 3).epoch(2),
                    jd.RandomPairBatcher(store, segs, 8, 20, 3).epoch(2),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_embedding_store_matches_jax():
    rng = np.random.default_rng(1)
    emb = {f"{i:010d}.jpg": rng.normal(size=(1, 4, 8, 16)).astype(np.float32)
           for i in range(0, 30, 3)}
    emb["notes.txt"] = np.zeros(1)
    for indices in (None, [3, 9, 27]):
        ours, ref = td.EmbeddingStore(emb, indices), jd.EmbeddingStore(
            emb, indices)
        np.testing.assert_array_equal(ours.array, ref.array)
        np.testing.assert_array_equal(ours.indices, ref.indices)
        np.testing.assert_array_equal(ours.gather([[3, 9]]),
                                      ref.gather([[3, 9]]))


def test_frame_store_matches_jax(synth_video, tmp_path, monkeypatch):
    frames_dir, meta = synth_video
    idx = [5, 0, 17, 33, 59, 33]
    ours = td.FrameStore(frames_dir, idx, resolution=(24, 16))
    ref = jd.FrameStore(frames_dir, idx, resolution=(24, 16), decoder="pil")
    np.testing.assert_array_equal(ours.array, ref.array)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    assert ours.item_shape == (24, 16, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours.rows([[59, 0]]), [[4, 0]])
    # decoder="native" builds the library (into a temporary directory) and
    # decodes the same frames, within a few levels of PIL's resize.
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    nat = td.FrameStore(frames_dir, idx, resolution=(24, 16),
                        decoder="native")
    assert nat.decoder == "native" and nat.array.shape == ref.array.shape
    np.testing.assert_array_equal(nat.indices, ref.indices)
    assert np.abs(nat.array.astype(int) - ref.array.astype(int)).mean() < 5
    store, splits = td.make_split_stores(frames_dir, meta, (32, 32),
                                         0.15, 0.15)
    _assert_same_split(splits, jax_split(meta.state_segments(), 0.15, 0.15))
    assert len(store.array) == sum(len(s) for s in splits.train + splits.val
                                   + splits.test)


def test_modal_codes_hamming_and_consistency_match_jax():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2, (40, 6)).astype(np.float32)
    codes[:12] = codes[0]                   # a clear mode in state 0
    labels = np.repeat(np.arange(4), 10)
    labels[-3:] = 5                         # state 4 empty, state 5 small
    modal = th.modal_codes(codes, labels, 6)
    np.testing.assert_array_equal(modal, jh.modal_codes(codes, labels, 6))
    np.testing.assert_array_equal(th.adjacent_hamming(modal),
                                  jh.adjacent_hamming(modal))
    assert modal_consistency(codes, labels, 6) == \
        jax_modal_consistency(codes, labels, 6)
