"""The port's multi-video slice on the CPU: the counterparts of
``tests/test_multi_video.py``, ``combine_videos`` against ``svtpu``'s
(splits and labels), the counterpart of
``tests/test_cli_eval.py::test_train_multi_video``, and the trainer's
staging of a multi-video bank (one tensor; ``MultiStore.array`` untouched
by the size probe)."""
import numpy as np
import pytest
import torch

from svtpu.config import VideoMeta as JaxVideoMeta
from svtpu.data.multi import combine_videos as jax_combine
from svtpu_torch import cli
from svtpu_torch.config import TrainConfig, VideoMeta, rbvae_variant
from svtpu_torch.data.multi import OFFSET, MultiStore, combine_videos
from svtpu_torch.training.trainer import Trainer, _staging_nbytes

from test_torch_cli import video_dir  # noqa: F401  (a fixture)

CPU = ["--device", "cpu"]


class ArrayStore:
    def __init__(self, n, base):
        rng = np.random.default_rng(base)
        self.array = (rng.integers(0, 255, (n, 16, 16, 3), dtype=np.uint8))

    @property
    def item_shape(self):
        return self.array.shape[1:]

    def gather(self, idx):
        return self.array[np.asarray(idx)]


class RowStore(ArrayStore):
    """An ``ArrayStore`` with the staging interface (``rows``)."""

    def rows(self, idx):
        return np.asarray(idx)


def _spec(store=ArrayStore):
    a = (store(48, 0),
         VideoMeta("a", flags=(16, 32), last_frame=47, grey_out=0))
    b = (store(30, 1),
         VideoMeta("b", flags=(10,), last_frame=29, grey_out=0))
    return [a, b]


def test_combine_videos_states_and_labels():
    store, splits, labels = combine_videos(_spec(), 0.15, 0.15)
    assert len(splits.train) == 3 + 2          # states concat across videos
    # Video b's ids live in the OFFSET block and map to states 3..4.
    b_ids = [i for i in labels if i >= OFFSET]
    assert b_ids and all(labels[i] in (3, 4) for i in b_ids)
    a_ids = [i for i in labels if i < OFFSET]
    assert all(labels[i] in (0, 1, 2) for i in a_ids)


@pytest.mark.parametrize("pcts", [(0.15, 0.15), (0.1, 0.1), (0.3, 0.2)])
def test_combine_videos_matches_svtpu(pcts):
    specs = _spec() + [(ArrayStore(25, 2), VideoMeta(
        "c", flags=(5, 12, 20), last_frame=24, grey_out=2))]
    ours, splits, labels = combine_videos(specs, *pcts)
    ref, jsplits, jlabels = jax_combine(
        [(s, JaxVideoMeta(m.name, m.flags, m.last_frame, m.grey_out))
         for s, m in specs], *pcts)
    for part in ("train", "val", "test"):
        assert splits.of(part) == jsplits.of(part)
    assert labels == jlabels
    assert [s is t for s, t in zip(ours.stores, ref.stores)] == [True] * 3


def test_multistore_gather_routes_by_video():
    specs = _spec()
    store = MultiStore([s for s, _ in specs])
    ids = np.array([[0, OFFSET + 0], [5, OFFSET + 5]])
    out = store.gather(ids)
    assert out.shape == (2, 2, 16, 16, 3)
    np.testing.assert_array_equal(out[0, 0], specs[0][0].array[0])
    np.testing.assert_array_equal(out[0, 1], specs[1][0].array[0])


def test_multistore_refuses_bad_stores():
    with pytest.raises(ValueError, match="at least one"):
        MultiStore([])
    small = ArrayStore(4, 0)
    small.array = small.array[:, :8]
    with pytest.raises(ValueError, match="item_shape"):
        MultiStore([ArrayStore(4, 0), small])
    with pytest.raises(AttributeError):
        MultiStore([ArrayStore(4, 0)]).array       # no rows: no staging


def test_triplet_training_across_videos():
    store, splits, labels = combine_videos(_spec(), 0.15, 0.15)
    mcfg = rbvae_variant("triplet", latent_dim=6, input_hw=(16, 16))
    tcfg = TrainConfig(batch_size=8, objective="triplet",
                       select_by="val_loss")
    tr = Trainer(mcfg, tcfg, store, splits, flags=[], seed=0,
                 labels_by_index=labels, device="cpu")
    hist = tr.train(num_epochs=1)
    assert np.isfinite(hist["train_losses"][0]["triplet_loss"])
    # consistency over combined states computes with the explicit label map
    w, pct = tr.state_consistency(hist["final_state"].model, 0.2)
    assert 0.0 <= w <= 1.0 and len(pct) == 5


def test_multistore_staging_rows_match_gather():
    """MultiStore.array + rows() (the device-staging interface) index the
    same frames that gather() returns."""
    ms = MultiStore([RowStore(5, 0), RowStore(7, 1)])
    gids = np.array([0, 3, OFFSET + 0, OFFSET + 6, 4])
    np.testing.assert_array_equal(ms.array[ms.rows(gids)], ms.gather(gids))
    assert len(ms.array) == 12


def test_sep_aggregate_min_catches_single_merged_video():
    """``sep_aggregate="min"``: the mean adjacent-Hamming scalar is blind
    to one video's states all sharing a code while the other video
    separates widely; the min aggregation reports 0."""
    store, splits, labels = combine_videos(_spec(), 0.15, 0.15)
    mcfg = rbvae_variant("contrastive", latent_dim=6, input_hw=(16, 16))

    def make(agg):
        tr = Trainer(mcfg, TrainConfig(batch_size=8, sep_aggregate=agg),
                     store, splits, flags=[], seed=0,
                     labels_by_index=labels, device="cpu")
        # Video a's states (0,1,2) merged on one code, video b's states
        # (3,4) mutually and jointly separated.
        by_state = np.array([[0, 0, 0, 0, 0, 0],
                             [0, 0, 0, 0, 0, 0],
                             [0, 0, 0, 0, 0, 0],
                             [1, 1, 1, 0, 0, 0],
                             [1, 1, 1, 1, 1, 1]], np.float32)

        def fake_val_codes(model, val_idx, temperature, noise, seed):
            return by_state[[labels[i] for i in val_idx]]

        tr._val_codes = fake_val_codes
        return tr.state_separation(None, 0.2)[0]

    assert make("mean") == pytest.approx((0 + 0 + 3 + 3) / 4)
    assert make("min") == 0.0


# --- staging


class CountingMultiStore(MultiStore):
    reads = 0

    @property
    def array(self):
        CountingMultiStore.reads += 1
        return MultiStore.array.fget(self)


def test_staging_nbytes_sums_substores_without_touching_array():
    specs = _spec(RowStore)
    ms = CountingMultiStore([s for s, _ in specs])
    assert _staging_nbytes(ms) == (48 + 30) * 16 * 16 * 3
    assert CountingMultiStore.reads == 0 and ms._array is None
    assert _staging_nbytes(MultiStore([s for s, _ in _spec()])) == 0


def test_trainer_stages_a_multi_video_bank_as_one_tensor():
    store, splits, labels = combine_videos(_spec(RowStore), 0.15, 0.15)
    mcfg = rbvae_variant("contrastive", latent_dim=6, input_hw=(16, 16))
    tr = Trainer(mcfg, TrainConfig(batch_size=8, stage_frames=True), store,
                 splits, flags=[], labels_by_index=labels, device="cpu")
    assert isinstance(tr._bank, torch.Tensor)
    assert tuple(tr._bank.shape) == (78, 16, 16, 3)
    assert tr._bank.numel() == sum(s.array.size for s in store.stores)
    np.testing.assert_array_equal(tr._bank.numpy(), store.array)


# --- the command line


def test_train_multi_video(tmp_path, video_dir):  # noqa: F811
    """``--multi`` trains two videos on one global state axis end to end,
    and the checkpoint evaluates through ``eval-consistency`` and
    ``eval-hamming`` on that axis (6 states, 5 adjacent pairs)."""
    flags_file = tmp_path / "transition_flags.txt"
    flags_file.write_text(
        "vid_a:\n[16, 32], last_frame = 47, grey_out = 2\n"
        "vid_b:\n[16, 32], last_frame = 47, grey_out = 2\n")
    multi = ["--multi", f"vid_a={video_dir}", "--multi", f"vid_b={video_dir}",
             "--flags-file", str(flags_file), "--resolution", "32",
             "--latent-dim", "8"]
    cli.main(["train", *multi, "--epochs", "1", "--batch-size", "4",
              "--sep-aggregate", "min", "--save-path", str(tmp_path / "ckpt"),
              *CPU])
    assert (tmp_path / "ckpt" / "best.pt").exists()
    out = tmp_path / "multi_eval"
    cli.main(["eval-consistency", *multi, "--ckpt", str(tmp_path / "ckpt"),
              "--trials", "2", "--out-dir", str(out), *CPU])
    assert len((out / "consistency.csv").read_text().splitlines()) > 1
    cli.main(["eval-hamming", *multi, "--ckpt", str(tmp_path / "ckpt"),
              "--out-dir", str(out), *CPU])
    ham = (out / "hamming.csv").read_text().strip().splitlines()
    assert len(ham) == 1 + 5      # header + 5 adjacent global-state pairs


def test_train_multi_needs_the_contrastive_variant(tmp_path, video_dir):  # noqa: F811
    with pytest.raises(SystemExit, match="contrastive"):
        cli.main(["train", "--multi", f"a={video_dir}", "--variant",
                  "triplet", *CPU])


def test_train_multi_video_preset_defaults(monkeypatch):
    """``--preset multi-video --multi ...`` reaches the trainer with the
    preset's values and the global label map."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_trainer(mcfg, tcfg, store, splits, flags, **kw):
        seen.update(mcfg=mcfg, tcfg=tcfg, store=store, flags=flags, **kw)
        raise Stop

    monkeypatch.setattr("svtpu_torch.training.trainer.Trainer", fake_trainer)
    monkeypatch.setattr(cli, "_multi_setup", lambda args: combine_videos(
        _spec(), args.test_pct, args.val_pct))
    with pytest.raises(Stop):
        cli.main(["train", "--preset", "multi-video", "--multi", "a=x",
                  "--multi", "b=y", *CPU])
    assert seen["tcfg"].final_temperature == 0.95
    assert seen["tcfg"].sep_aggregate == "min"
    assert seen["mcfg"].latent_dim == 25 and seen["flags"] == []
    assert isinstance(seen["store"], MultiStore)
    assert max(seen["labels_by_index"].values()) == 4
