"""The port's EMA, LR schedule, profiling and environment utilities and the
model summary on the CPU, against ``svtpu``'s where both have them."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from svtpu.config import rbvae_variant as jax_variant
from svtpu.models.rbvae import Seq2SeqBinaryVAE as JaxRBVAE
from svtpu.training import ema as jax_ema
from svtpu_torch.config import rbvae_variant
from svtpu_torch.models.visualize import summarize
from svtpu_torch.training import ema
from svtpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "k": rng.normal(size=(2, 3, 4)).astype(np.float32)}


def test_ema_update_matches_svtpu():
    """20 updates from the same numpy parameters: the averages within rtol
    1e-6 (f32) and the update counts equal."""
    p0 = _params(0)
    jstate = jax_ema.ema_init(p0)
    state = ema.ema_init({k: torch.from_numpy(v) for k, v in p0.items()})
    for i in range(20):
        p = _params(i + 1)
        jstate = jax_ema.ema_update(jstate, p, decay=0.999)
        state = ema.ema_update(state, {k: torch.from_numpy(v)
                                       for k, v in p.items()}, decay=0.999)
    assert state.updates == int(jstate.updates) == 20
    for k in p0:
        np.testing.assert_allclose(state.ema[k].numpy(),
                                   np.asarray(jstate.ema[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_ema_of_a_module_keeps_its_dtype_and_device():
    m = torch.nn.Linear(3, 2)
    w0 = m.weight.detach().clone()
    state = ema.ema_init(m)
    assert set(state.ema) == {"weight", "bias"}
    with torch.no_grad():
        m.weight.add_(1.0)
    state = ema.ema_update(state, m)
    # First update: decay min(0.9999, 2/11), so the average moves 9/11 of
    # the way to the new weights.
    torch.testing.assert_close(state.ema["weight"], w0 + 9 / 11)
    assert state.ema["weight"].dtype == torch.float32
    assert state.ema["weight"].device == m.weight.device
    assert state.updates == 1


def test_lambda_linear_schedule_matches_svtpu():
    base = 1e-3
    ours = ema.lambda_linear_schedule(base, 100, f_start=1e-6, f_max=1.0,
                                      f_min=0.5)
    ref = jax_ema.lambda_linear_schedule(base, 100, f_start=1e-6, f_max=1.0,
                                         f_min=0.5)
    steps = (0, 1, 50, 99, 100, 1000)
    for s in steps:
        assert abs(ours(s) - float(ref(s))) <= 1e-9, s
    # As a LambdaLR factor: the optimizer's lr after s scheduler steps.
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=base)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: ours(s) / base)
    lrs = []
    for s in range(1001):
        if s in steps:
            lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [float(ref(s)) for s in steps],
                               rtol=0, atol=1e-9)


def test_step_timer_and_sync(monkeypatch):
    """``sync`` reads one element of the first tensor it finds in a tensor,
    dict, list or tuple (past ``None``), and reads nothing where that
    tensor is empty or there is none."""
    read = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda t: read.append(t.clone()) or item(t))
    x = torch.ones(64, 64) @ torch.ones(64, 64)
    profiling.sync({"out": [x]})
    profiling.sync((None, torch.arange(3) + 5, x))
    assert [float(t) for t in read] == [64.0, 5.0]
    profiling.sync((None, torch.zeros(0), torch.arange(3)))
    profiling.sync({"none": None, "empty": []})
    assert len(read) == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1 and "traceEvents" in json.loads(
        files[0].read_text())
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_memory_stats_empty_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}


def test_environment_report_without_a_card_imports_no_jax():
    """In a fresh interpreter: the report imports nothing of JAX or
    ``svtpu``, reports the smoke test as not run, and reports a package
    that does not import as None (sklearn, matplotlib and cv2 are blocked
    there, which also keeps their imports out of the test's time)."""
    code = ("import json, sys; before = set(sys.modules); "
            "sys.modules.update(sklearn=None, matplotlib=None, cv2=None); "
            "from svtpu_torch.utils.env_check import environment_report; "
            "r = environment_report(); "
            "new = sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', "
            "'svtpu')); "
            "print(json.dumps({'report': r, 'new': new}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["new"] == []
    r = res["report"]
    assert r["cuda_available"] is False and r["devices"] == []
    assert r["device_smoke_test"] == "not run: no CUDA device"
    assert r["torch"] == torch.__version__ and "triton" in r
    assert r["sklearn"] is r["matplotlib"] is r["cv2"] is None
    assert r["numpy"] == np.__version__
    assert "jax" not in r and "flax" not in r


SUMMARY_CASES = {
    "simple": dict(input_hw=(32, 32)),
    "contrastive": dict(input_hw=(32, 32)),
    "percep": dict(input_hw=(16, 24)),
    "triplet": dict(input_hw=(32, 32)),
}


@pytest.mark.parametrize("variant", sorted(SUMMARY_CASES))
def test_summarize_counts_svtpus_parameters(variant, tmp_path):
    """The table's trainable total equals the size of ``svtpu``'s
    ``model.init`` tree exactly (its shapes traced, nothing compiled), and
    the dummy forward's reconstruction has the input's shape."""
    kw = SUMMARY_CASES[variant]
    table = summarize(rbvae_variant(variant, 8, **kw), batch=2,
                      time_steps=3, log_dir=str(tmp_path), device="cpu")
    jcfg = jax_variant(variant, 8, **kw)
    x0 = jax.numpy.zeros((1, 1) + tuple(jcfg.input_hw)
                         + (jcfg.in_channels,))
    shapes = jax.eval_shape(lambda k: JaxRBVAE(jcfg).init(
        {"params": k}, x0, 1.0, False, deterministic=True),
        jax.random.key(0))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(shapes))
    line = [ln for ln in table.splitlines() if ln.startswith("trainable:")]
    assert line and int(line[0].split()[1].replace(",", "")) == want
    assert "encoder_cnn.fc" in table and "bias_hh" in line[0]
    assert list(tmp_path.glob("events.out.tfevents.*"))
