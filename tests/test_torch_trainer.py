"""The port's Trainer on the CPU at tiny sizes (32x32, latent 8): the
counterparts of the key checks of tests/test_trainer_smoke.py, and one
epoch of svtpu's Trainer and the port's giving the same metric names."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from svtpu_torch.config import TrainConfig, VideoMeta, rbvae_variant
from svtpu_torch.data.datasets import EmbeddingStore, FrameStore
from svtpu_torch.data.segments import split_segments
from svtpu_torch.training.checkpoints import BestCheckpointer
from svtpu_torch.training.trainer import Trainer


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
    meta = VideoMeta("synth", flags=(20, 40), last_frame=59, grey_out=1)
    splits = split_segments(meta.state_segments(), 0.15, 0.15)
    all_idx = (list(splits.flat("train")) + list(splits.flat("val"))
               + list(splits.flat("test")))
    store = FrameStore(d, all_idx, resolution=(32, 32))
    return d, meta, splits, store


MCFG = rbvae_variant("contrastive", latent_dim=8, input_hw=(32, 32))


def _trainer(synth_video, seed=None, mcfg=MCFG, **cfg):
    _, meta, splits, store = synth_video
    base = dict(batch_size=8, num_epochs=2, num_steps_to_update=2,
                select_by="consistency")
    base.update(cfg)
    return Trainer(mcfg, TrainConfig(**base), store, splits, meta.flags,
                   seed=seed, device="cpu")


def _same_losses(ha, hb):
    for la, lb in zip(ha["train_losses"] + ha["val_losses"],
                      hb["train_losses"] + hb["val_losses"], strict=True):
        assert set(la) == set(lb)
        for k in la:
            np.testing.assert_allclose(la[k], lb[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def _same_params(ha, hb):
    a = ha["final_state"].model.state_dict()
    b = hb["final_state"].model.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_contrastive_end_to_end_with_checkpoint(synth_video, tmp_path):
    trainer = _trainer(synth_video)
    hist = trainer.train(num_epochs=2, save_path=str(tmp_path / "ckpt"))
    assert len(hist["train_losses"]) == 2
    for tl in hist["train_losses"]:
        assert np.isfinite(tl["total_loss"])
        assert {"recon_loss", "kl_loss", "contrast_loss"} <= set(tl)
    assert 0.0 <= hist["val_losses"][-1]["consistency_score"] <= 1.0
    tree, meta = BestCheckpointer(str(tmp_path / "ckpt")).restore("best")
    assert {"model", "optimizer"} <= set(tree) and "epoch" in meta
    model = trainer.init_state().model
    model.load_state_dict(tree["model"])
    assert meta["global_step"] == hist["final_state"].step > 0


def test_triplet_selects_by_val_loss(synth_video):
    trainer = _trainer(synth_video, mcfg=rbvae_variant(
        "triplet", latent_dim=8, input_hw=(32, 32)),
        objective="triplet", select_by="val_loss")
    hist = trainer.train(num_epochs=1)
    assert np.isfinite(hist["train_losses"][0]["triplet_loss"])
    assert np.isfinite(hist["best_metric"])


def test_simple_end_to_end(synth_video):
    frames_dir, meta, _, _ = synth_video
    segs = meta.state_segments()
    store = FrameStore(frames_dir, [i for s, e in segs for i in range(s, e)],
                       resolution=(64, 64))
    tr = Trainer(rbvae_variant("simple", latent_dim=8),
                 TrainConfig(batch_size=1, objective="simple"), store,
                 split_segments(segs), meta.flags, device="cpu")
    hist = tr.train_simple(segs, num_epochs=1)
    assert np.isfinite(hist["train_losses"][0]["total_loss"])
    assert hist["final_state"].step == len(segs)


def test_percep_path_with_embedding_store(synth_video):
    _, meta, splits, _ = synth_video
    rng = np.random.default_rng(1)
    emb = {f"{i:010d}.jpg": rng.normal(
        size=(1, 4, 8, 16)).astype(np.float32) + 3.0 * (i // 20)
        for i in range(60)}
    store = EmbeddingStore(emb)
    mcfg = rbvae_variant("percep", latent_dim=8, input_hw=(8, 16),
                         conv_features=(32, 32, 32), lstm_layers=2)
    trainer = Trainer(mcfg, TrainConfig(batch_size=8), store, splits,
                      meta.flags, device="cpu")
    hist = trainer.train(num_epochs=1)
    assert np.isfinite(hist["train_losses"][0]["total_loss"])


def test_resume_from_latest(synth_video, tmp_path):
    trainer = _trainer(synth_video)
    h1 = trainer.train(num_epochs=1, save_path=str(tmp_path / "ck"))
    h2 = trainer.train(num_epochs=3, save_path=str(tmp_path / "ck"),
                       resume=True)
    assert len(h2["train_losses"]) == 2
    # The step counter, so the temperature schedule, carries on.
    assert h2["final_state"].step == 3 * h1["final_state"].step


def test_latest_checkpoint_tracks_plateaus(synth_video, tmp_path):
    trainer = _trainer(synth_video, latest_every=1)
    trainer.train(num_epochs=4, save_path=str(tmp_path / "ck"))
    latest = json.loads((tmp_path / "ck" / "latest.json").read_text())
    assert latest["epoch"] == 3


def test_staged_bank_matches_unstaged(synth_video):
    tr_s = _trainer(synth_video, seed=3, stage_frames=True)
    tr_u = _trainer(synth_video, seed=3, stage_frames=False)
    assert tr_s._bank is not None and tr_u._bank is None
    hs, hu = tr_s.train(num_epochs=2), tr_u.train(num_epochs=2)
    _same_losses(hs, hu)
    _same_params(hs, hu)


def test_fused_epoch_matches_per_step_loop(synth_video):
    cfg = dict(num_epochs=3, stage_frames=True, select_by="combined",
               batch_size=4)
    tr_f = _trainer(synth_video, seed=5, **cfg)
    tr_u = _trainer(synth_video, seed=5, fused_epoch=False, **cfg)
    hf, hu = tr_f.train(num_epochs=3), tr_u.train(num_epochs=3)
    assert tr_f.train_batcher.num_batches() > 1
    _same_losses(hf, hu)
    assert hf["best_epoch"] == hu["best_epoch"]
    assert hf["frames_seen"] == hu["frames_seen"] > 0
    _same_params(hf, hu)


def test_fused_epoch_empty_train_epoch(synth_video):
    tr = _trainer(synth_video, stage_frames=True)
    tr.train_batcher.epoch_indices = lambda epoch: iter(())
    hist = tr.train(num_epochs=1)
    assert hist["train_losses"][0] == {}
    assert np.isfinite(hist["val_losses"][0]["consistency_score"])


def test_auto_restart_on_basin_failure(synth_video):
    trainer = _trainer(synth_video, num_epochs=4, select_by="combined",
                       restart_check_epoch=1, restart_min_sep=1e9,
                       max_restarts=2)
    hist = trainer.train(num_epochs=4)
    assert len(hist["train_losses"]) == 4
    assert [r["seed_offset"] for r in hist["restarts"]] == [1000, 2000]
    for tl in hist["train_losses"]:
        assert np.isfinite(tl["total_loss"])


def test_restart_on_min_fires_when_mean_is_healthy(synth_video):
    base = dict(num_epochs=3, select_by="combined", restart_check_epoch=1,
                restart_min_sep=5.0, max_restarts=1)

    def scripted_sep(model, temperature, seed=0):
        return 0.0, 0.5, np.array([25.0, 0.0])   # mean 12.5, min 0

    tr_min = _trainer(synth_video, restart_on="min", **base)
    tr_min.state_separation = scripted_sep
    assert len(tr_min.train(num_epochs=3)["restarts"]) == 1
    tr_mean = _trainer(synth_video, **base)
    tr_mean.state_separation = scripted_sep
    assert tr_mean.train(num_epochs=3)["restarts"] == []


def test_restart_resets_best_metric(synth_video, tmp_path):
    trainer = _trainer(synth_video, num_epochs=3, restart_check_epoch=1,
                       restart_min_sep=1e9, max_restarts=1)
    hist = trainer.train(num_epochs=3, save_path=str(tmp_path / "ck"))
    restart_epoch = hist["restarts"][0]["epoch"]
    assert hist["best_epoch"] > restart_epoch
    assert np.isfinite(hist["best_metric"])
    _, meta = BestCheckpointer(str(tmp_path / "ck")).restore("best")
    assert int(meta["epoch"]) > restart_epoch


def test_trap_guard_raises_the_floor(synth_video):
    cfg = dict(num_epochs=4, init_temperature=2.0, final_temperature=0.1,
               anneal_rate=0.1, num_steps_to_update=1, batch_size=4)
    tr = _trainer(synth_video, trap_guard_ratio=1e-6, **cfg)
    hist = tr.train(num_epochs=4)
    ev = hist["trap_guard"]
    assert ev["first_raise_epoch"] == 0 and ev["abs_h"] > 0
    assert ev["floor"] == pytest.approx(ev["abs_h"] / 1e-6)
    temps = [tl["temperature"] for tl in hist["train_losses"]]
    assert temps[1] > 1.0 and temps[3] > 1.0
    assert "ctxfree_abs_h" in hist["val_losses"][-1]
    hist2 = _trainer(synth_video, **cfg).train(num_epochs=4)
    assert "trap_guard" not in hist2
    assert hist2["train_losses"][3]["temperature"] < temps[3]


def test_selection_tiebreak_never_improving_metric(synth_video, tmp_path):
    trainer = _trainer(synth_video, select_by="combined")
    det_by_epoch = [0.2, 0.5, 0.9, 0.7]
    calls = []

    def fake_sep(model, temperature, seed=0):
        calls.append(0)
        return 0.0, det_by_epoch[len(calls) - 1], np.zeros(2)

    trainer.state_separation = fake_sep
    hist = trainer.train(num_epochs=4, save_path=str(tmp_path / "ck"))
    assert all(v["combined_score"] == 0.0 for v in hist["val_losses"])
    assert hist["best_epoch"] == 2
    _, meta = BestCheckpointer(str(tmp_path / "ck")).restore("best")
    assert int(meta["epoch"]) == 2


def test_selection_tiebreak_mean_sep_then_epoch(synth_video, tmp_path):
    trainer = _trainer(synth_video, select_by="combined")
    hams = [np.array([0.0, 2.0]), np.array([4.0, 6.0]),
            np.array([1.0, 1.0]), np.array([1.0, 1.0])]
    calls = []

    def fake_sep(model, temperature, seed=0):
        calls.append(0)
        return 0.0, 0.5, hams[len(calls) - 1]

    trainer.state_separation = fake_sep
    hist = trainer.train(num_epochs=4, save_path=str(tmp_path / "ck"))
    assert hist["best_epoch"] == 1 and hist["best_ham_vector"] == [4, 6]

    trainer2 = _trainer(synth_video, select_by="combined")
    trainer2.state_separation = (
        lambda model, temperature, seed=0: (0.0, 0.5, np.array([3.0])))
    sc = trainer2.state_consistency
    trainer2.state_consistency = (
        lambda model, temperature, noise=True, seed=0:
        (0.0, sc(model, temperature, noise=noise, seed=seed)[1]))
    hist2 = trainer2.train(num_epochs=3, save_path=str(tmp_path / "ck2"))
    assert hist2["best_epoch"] == 2
    _, meta = BestCheckpointer(str(tmp_path / "ck2")).restore("best")
    assert int(meta["epoch"]) == 2


def test_val_every_probe_cadence(synth_video, tmp_path):
    trainer = _trainer(synth_video, num_epochs=8, select_by="combined",
                       val_every=3, batch_size=16)
    hist = trainer.train(num_epochs=8, save_path=str(tmp_path / "ckpt"))
    probed = [e for e, v in enumerate(hist["val_losses"]) if v]
    assert probed == [0, 3, 6, 7]
    for e in (1, 2, 4, 5):
        assert np.isfinite(hist["train_losses"][e]["total_loss"])
    assert hist["best_epoch"] in probed
    _, meta = BestCheckpointer(str(tmp_path / "ckpt")).restore("best")
    assert int(meta["epoch"]) in probed


def test_val_every_restart_check_still_probes(synth_video):
    trainer = _trainer(synth_video, num_epochs=4, select_by="combined",
                       val_every=5, restart_check_epoch=2,
                       restart_min_sep=1e9, max_restarts=1, batch_size=16)
    hist = trainer.train(num_epochs=4)
    assert [r["epoch"] for r in hist["restarts"]] == [1]
    assert [bool(v) for v in hist["val_losses"]] == [True, True, False,
                                                      True]


def test_restart_reroll_stream_rebuilds_pair_table(synth_video):
    base = dict(num_epochs=3, select_by="combined", restart_check_epoch=1,
                restart_min_sep=1e9, max_restarts=1)
    tr = _trainer(synth_video, restart_reroll="stream", **base)
    table, val_table = (tr.train_batcher.pair_table.copy(),
                        tr.val_batcher.pair_table.copy())
    assert len(tr.train(num_epochs=3)["restarts"]) == 1
    assert not np.array_equal(tr.train_batcher.pair_table, table)
    assert np.array_equal(tr.val_batcher.pair_table, val_table)
    assert tr._base_seed == tr.seed + 1 + 1000

    tr2 = _trainer(synth_video, **base)
    table2 = tr2.train_batcher.pair_table.copy()
    assert len(tr2.train(num_epochs=3)["restarts"]) == 1
    assert np.array_equal(tr2.train_batcher.pair_table, table2)
    assert tr2._base_seed == tr2.seed + 1


def test_best_checkpointer_modes_and_sel_key(tmp_path):
    ck = BestCheckpointer(tmp_path / "max", mode="max")
    assert ck.save({"w": torch.ones(2)}, epoch=0, metric=0.5)
    assert not ck.save({"w": torch.ones(2) * 2}, epoch=1, metric=0.4)
    assert ck.save({"w": torch.ones(2) * 3}, epoch=2, metric=0.9)
    tree, meta = ck.restore("best")
    assert meta["metric"] == 0.9 and float(tree["w"][0]) == 3
    assert ck.restore("latest")[1]["epoch"] == 2
    ck2 = BestCheckpointer(tmp_path / "min", mode="min")
    assert ck2.save({"w": torch.zeros(1)}, epoch=0, metric=1.0)
    assert ck2.save({"w": torch.zeros(1)}, epoch=1, metric=0.2)
    assert not ck2.save({"w": torch.zeros(1)}, epoch=2, metric=0.7)
    lex = BestCheckpointer(tmp_path / "lex")
    assert lex.save({}, epoch=0, metric=0.0, sel_key=(0.0, 0.2, 1.0, 0))
    assert lex.save({}, epoch=1, metric=0.0, sel_key=(0.0, 0.9, 0.0, 1))
    assert not lex.save({}, epoch=2, metric=0.0, sel_key=(0.0, 0.5, 9.0, 2))
    assert lex.restore("best")[1]["epoch"] == 1


def test_trainer_checks_its_mesh(synth_video):
    """Without a process group the world is one rank: a mesh larger than it
    raises ValueError naming both sizes, and the (1,) and (1, 1) meshes
    train (one step each)."""
    for bad in (dict(mesh_shape=(1, 2), mesh_axes=("data", "model")),
                dict(mesh_shape=(4,))):
        with pytest.raises(ValueError, match="needs . ranks; there are 1"):
            _trainer(synth_video, **bad)
    for ok in (dict(mesh_shape=(1,)),
               dict(mesh_shape=(1, 1), mesh_axes=("data", "model"))):
        tr = _trainer(synth_video, **ok)
        state = tr.init_state()
        batch = next(iter(tr.train_batcher.epoch_indices(0)))
        metrics, _ = tr._train_step(state, torch.from_numpy(batch))
        assert state.step == 1 and np.isfinite(float(metrics["total_loss"]))


def test_metric_names_match_svtpu(synth_video):
    """One epoch of svtpu's Trainer and the port's on the same video: the
    same train and val metric names."""
    from svtpu.config import TrainConfig as JaxTrainConfig
    from svtpu.config import rbvae_variant as jax_variant
    from svtpu.data.datasets import FrameStore as JaxFrameStore
    from svtpu.training.trainer import Trainer as JaxTrainer

    frames_dir, meta, splits, store = synth_video
    cfg = dict(batch_size=8, num_steps_to_update=2, contrast_on="p",
               contextfree_contrast=True, l1_logits=0.1, select_by="combined",
               trap_guard_ratio=0.5)
    jstore = JaxFrameStore(frames_dir, store.indices, resolution=(32, 32),
                           decoder="pil")
    jhist = JaxTrainer(jax_variant("contrastive", 8, input_hw=(32, 32)),
                       JaxTrainConfig(**cfg), jstore, splits,
                       meta.flags).train(num_epochs=1)
    hist = Trainer(MCFG, TrainConfig(**cfg), store, splits, meta.flags,
                   device="cpu").train(num_epochs=1)
    assert set(hist["train_losses"][0]) == set(jhist["train_losses"][0])
    assert set(hist["val_losses"][0]) == set(jhist["val_losses"][0])
    assert set(hist) == set(jhist)
