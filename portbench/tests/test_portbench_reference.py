"""The plain references against the program's CPU route at a tiny size, on
the same seeded weights and inputs (this test imports both; the reference
modules themselves import nothing of the program)."""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import rbvae as ref
from portbench.run import run_cell

BENCH = Path(__file__).resolve().parents[1]
CONF = json.loads((BENCH / "configs" / "rbvae-flagship.json").read_text())
TINY_TRAIN = {"config": {"model": {"input_hw": [32, 32],
                                   "pallas_trunk": False,
                                   "pallas_sampler": False},
                         "train": {"batch_size": 4}},
              "traffic": {"warm_epochs": 3}}


def f32_model(model: dict):
    from svtpu_torch.config import RBVAEConfig

    m = dict(model, compute_dtype="float32", pallas_trunk=False,
             pallas_sampler=False)
    return RBVAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in m.items()})


def test_encode_h_matches_the_program():
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.ops.image import resize_bilinear, to_float01

    model = CONF["model"]
    w = ref.init_weights(model, 5, "cpu", {"encoder_cnn.conv.": 6 ** 0.5,
                                           "encoder_cnn.fc.": 3 ** 0.5})
    frames = torch.randint(0, 256, (3, 40, 72, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    prog = Seq2SeqBinaryVAE(f32_model(model), device="cpu")
    prog.load_state_dict(w)
    with torch.no_grad():
        x = resize_bilinear(to_float01(frames), (256, 256))
        _, h, _ = prog._encode_to_latent(x[:, None], 0.2, True, 0.0, None,
                                         None)
        want = ref.encode_h(w, model, frames)
        low = ref.encode_h(w, model, frames, low=True).float()
    torch.testing.assert_close(h[:, 0], want, atol=2e-5, rtol=1e-4)
    # The control is a different computation, not the same one again.
    assert float((low - want).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32"])
def test_train_steps_match_the_program(dtype):
    """The train driver's own check, with the program in float32: the
    reference follows the trainer's first steps (weights, batches, noise,
    dropout masks, Adam) to float32 rounding."""
    sizes = json.loads(json.dumps(TINY_TRAIN))
    sizes["config"]["model"]["compute_dtype"] = dtype
    sizes["limits"] = {"loss_gap": 1e-5, "recon_gap": 1e-4,
                       "grad_gap": 1e-4, "update_gap": 1e-2,
                       "dec_grad_diff": 1e-4}
    r = run_cell("flagship-train", 2 ** 31 + 7, 0.5, False,
                 time.perf_counter(), device="cpu", sizes=sizes)
    assert set(r["checks"]) == set(sizes["limits"])
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("seed", [0, 1, 17, 2 ** 31 + 12345, 3100000051])
def test_step_batches_match_the_program(seed):
    """The reference's pairs and epoch batches are the trainer's."""
    from svtpu_torch.config import BUILTIN_VIDEOS
    from svtpu_torch.data.datasets import PairBatcher
    from svtpu_torch.data.segments import split_segments

    from portbench.reference import data as refdata

    sp = split_segments(BUILTIN_VIDEOS["chinese_chess"].state_segments(),
                        0.1, 0.1)
    batcher = PairBatcher(None, sp.train, 32, seed=seed)
    theirs = [b for e in range(2) for b in batcher.epoch_frame_indices(e)]
    ours = refdata.step_batches(CONF["video"], 32, seed, len(theirs))
    assert all(np.array_equal(a, b) for a, b in zip(theirs, ours))
