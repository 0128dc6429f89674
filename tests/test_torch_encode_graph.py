"""The serving encodes' graph route, on the CPU: the route rule; the guard
that refuses a CUDA graph off the card; the samplers with the temperature
and the noise scale in 0-dim tensors (what a graph holds) against the
by-number calls, bit for bit; the launch counts a capture takes back and a
replay adds; and, against ``svtpu``, the trainer's probe encode at two
temperatures and the bundle's encode of uint8 frames (its ``/ 255`` now on
the device side of the encode). The graphs themselves run on the card only
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
import contextlib

import numpy as np
import pytest
import torch

from svtpu_torch.config import TrainConfig, rbvae_variant
from svtpu_torch.data.segments import split_segments
from svtpu_torch.evaluation.common import RBVAEBundle
from svtpu_torch.config import PerceptualConfig
from svtpu_torch.models.autoencoder_kl import AutoencoderKL
from svtpu_torch.models.encode_graph import EncodeCaptureError, EncodeGraph
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops import cuda_graph
from svtpu_torch.ops.binarize import binary_concrete
from svtpu_torch.ops.binarize_cuda import (binary_concrete_fused,
                                           binary_concrete_fused_plain,
                                           scalar_args)
from svtpu_torch.ops.lstm import LSTM
from svtpu_torch.ops.lstm_cuda import (lstm_binary_concrete,
                                       lstm_binary_concrete_plain)
from svtpu_torch.parallel.mesh import make_mesh
from svtpu_torch.perceptual.embed import PerceptualEncoder
from svtpu_torch.pipeline import VideoSymbolPipeline
from svtpu_torch.training.trainer import Trainer

from _torch_port import ArrayStore, eval_frames, eval_model

TEMP, SCALE = 0.37, 0.23
DTYPES = [torch.float32, torch.bfloat16]


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def test_route_follows_the_device_and_the_mesh():
    """CUDA (no mesh, or no "model" axis) → a graph; the CPU and a "model"
    axis → eager: one rule, the step's route's."""
    route = cuda_graph.graph_route
    assert route(torch.device("cuda", 0)) == "graph"
    assert route("cuda", make_mesh((1,), ("data",))) == "graph"
    assert route("cuda", make_mesh((1, 1), ("data", "model"))) == "eager"
    assert route("cpu") == route("cpu", make_mesh((1,), ("data",))) \
        == "eager"


def test_graph_off_the_card_raises_and_never_runs_eagerly(monkeypatch):
    """An ``EncodeGraph`` on the CPU raises; a CPU pipeline forced onto the
    graph route raises there and never encodes in the graph's place."""
    with pytest.raises(EncodeCaptureError, match="CUDA device, not cpu"):
        EncodeGraph("cpu")
    cfg = rbvae_variant("contrastive", 6, input_hw=(32, 32))
    sd = Seq2SeqBinaryVAE(cfg, device="cpu").state_dict()
    pipe = VideoSymbolPipeline(cfg, sd, device="cpu")
    assert not pipe._graphed
    calls = []
    monkeypatch.setattr(pipe.model, "encode",
                        lambda *a, **k: calls.append(1))
    pipe._graphed = True
    frames = np.zeros((2, 32, 32, 3), np.uint8)
    with pytest.raises(EncodeCaptureError, match="CUDA device, not cpu"):
        pipe.run_frames(frames)
    assert calls == []


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "noise-off"])
@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_standalone_sampler_takes_tensor_scalars(dtype, noisy, hard):
    """``binary_concrete_fused`` (the plain version on the CPU) with the
    temperature and the noise scale as 0-dim float32 tensors equals the
    by-number call bit for bit."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 3, 25)).astype(np.float32)).to(dtype)
    seed = torch.tensor([12345])
    ref = binary_concrete_fused(x, seed, TEMP, SCALE, hard, noisy=noisy)
    got = binary_concrete_fused(x, seed, _f32(TEMP), _f32(SCALE), hard,
                                noisy=noisy)
    assert got.dtype == dtype and torch.equal(got, ref)
    assert torch.equal(binary_concrete_fused_plain(
        x, 12345, _f32(TEMP), _f32(SCALE), hard, noisy=noisy), ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "noise-off"])
def test_fused_lstm_sampler_takes_tensor_scalars(dtype, noisy):
    """``lstm_binary_concrete`` (the plain version on the CPU), soft codes
    and ``h``: tensor scalars equal numbers bit for bit."""
    torch.manual_seed(0)
    lstm = LSTM(25, 25, 2, True, dtype)
    x = torch.randn(8, 3, 25).to(dtype)
    with torch.no_grad():
        ref = lstm_binary_concrete_plain(lstm, x, 77, TEMP, SCALE, False,
                                         noisy=noisy)
        got = lstm_binary_concrete(lstm, x, torch.tensor([77]), _f32(TEMP),
                                   _f32(SCALE), False, noisy=noisy,
                                   return_h=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "noise-off"])
def test_plain_sampler_takes_tensor_scalars(dtype, noisy):
    """The plain ``binary_concrete`` (the torch route's sampler) casts a
    0-dim float32 tensor to the logits' dtype as it casts the number."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(16, 3, 25)).astype(np.float32)).to(dtype)

    def run(t, s):
        gen = torch.Generator().manual_seed(5) if noisy else None
        return binary_concrete(x, gen, t, True, 1e-8, s)

    assert torch.equal(run(_f32(TEMP), _f32(SCALE)), run(TEMP, SCALE))


def test_kernel_scalar_arguments():
    """A number goes by value; a 0-dim float32 tensor on the device by its
    address; anything else is refused before a launch."""
    cpu = torch.device("cpu")
    assert scalar_args(0.5, cpu, "temperature") == (None, 0.5)
    t = _f32(0.5)
    assert scalar_args(t, cpu, "temperature") == (t.data_ptr(), 0.0)
    for bad in (torch.tensor(0.5, dtype=torch.float64), torch.ones(1),
                _f32(0.5)):
        with pytest.raises(ValueError, match="0-dim float32"):
            scalar_args(bad, torch.device("cuda", 0), "temperature")


class _Counter:
    """A stub kernel wrapper: counts its launches as the wrappers do."""

    def __init__(self, by_kernel=False):
        self.launches = 0
        if by_kernel:
            self.launches_by_kernel = {"a": 0, "b": 0}

    def __call__(self, kernel=None):
        self.launches += 1
        if kernel is not None:
            self.launches_by_kernel[kernel] += 1


@pytest.fixture
def fake_capture(monkeypatch):
    """``torch.cuda``'s graph capture stubbed out: the body runs on the
    CPU, as a capture records it (the stub does not tell recording from
    running; the bookkeeping is what is under test)."""

    class FakeGraph:
        def __init__(self):
            self.generators = []

        def register_generator_state(self, gen):
            self.generators.append(gen)

        def replay(self):
            pass

        def reset(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, **kw:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


def test_capture_takes_back_its_launches_and_a_replay_adds_them(fake_capture):
    """Launches counted during a capture ran nothing: ``capture`` takes
    them back and returns them; each replay adds them again, by kernel
    too. So after a capture and three replays a counter holds what three
    real runs would."""
    one, two = _Counter(), _Counter(by_kernel=True)
    launches = cuda_graph.Launches([one, two])
    one(), two("a")                          # an eager call before
    gen = torch.Generator()

    def body():
        one(), two("b"), two("b")
        return torch.zeros(())

    graph, out, delta = cuda_graph.capture(body, [gen], "cpu", RuntimeError,
                                           "a stub", "", launches)
    assert graph.generators == [gen] and out.shape == ()
    assert delta == [(1, {}), (2, {"a": 0, "b": 2})]
    assert (one.launches, two.launches, two.launches_by_kernel) == \
        (1, 1, {"a": 1, "b": 0})
    for _ in range(3):
        launches.add(delta)
    assert (one.launches, two.launches, two.launches_by_kernel) == \
        (4, 7, {"a": 1, "b": 6})


def test_failed_capture_names_its_first_cause(fake_capture):
    """A capture whose body raises: the counts are as before it, and the
    error names the body's file and line and says nothing runs eagerly."""
    one = _Counter()
    launches = cuda_graph.Launches([one])

    def body():
        one()
        float(torch.ones(()).sum())
        raise KeyError("the body's own error")

    with pytest.raises(EncodeCaptureError) as e:
        cuda_graph.capture(body, [], "cpu", EncodeCaptureError,
                           "the encode 'stub'", "no eager encode", launches)
    msg = str(e.value)
    assert "test_torch_encode_graph.py" in msg and "KeyError" in msg
    assert msg.startswith("capturing the encode 'stub' as a CUDA graph")
    assert msg.endswith("no eager encode") and one.launches == 0


def test_a_key_runs_eagerly_then_captures_then_replays(fake_capture,
                                                     monkeypatch):
    """``EncodeGraph``'s protocol on the stubbed capture: a key's first call
    runs eagerly, its second captures and replays, a later one replays;
    each replay adds the launches its capture counted."""
    monkeypatch.setattr(cuda_graph, "on_side_stream", lambda fn, d: fn())
    monkeypatch.setattr(cuda_graph, "pool_bytes", lambda graph: 0)
    counter = _Counter()
    counter.__name__ = "stub"
    graphs = EncodeGraph.__new__(EncodeGraph)   # the CPU stands for a card
    vars(graphs).update(device=torch.device("cpu"),
                        launches=cuda_graph.Launches([counter]), _keys={})
    module = torch.nn.Linear(1, 1)

    def body(inputs, temperature, noise_scale, gen):
        counter()
        return inputs[0] * temperature + torch.rand((), generator=gen)

    def call(tag, x, seed=3):
        return graphs(tag, module, (True,), body, (x,), 2.0, 0.1, seed)

    captures, replays = EncodeGraph.captures, EncodeGraph.replays
    x = torch.arange(3.0)
    first = call("enc", x)
    (key,) = graphs.report()
    assert (key["eager"], key["captures"], key["replays"]) == (1, 0, 0)
    assert key["replay_launches"] is None and counter.launches == 1
    np.testing.assert_array_equal(call("enc", x), first)
    np.testing.assert_array_equal(call("enc", x), first)
    (key,) = graphs.report()
    assert (key["eager"], key["captures"], key["replays"]) == (1, 1, 2)
    assert key["replay_launches"] == {"stub": 1} and counter.launches == 3
    assert (EncodeGraph.captures - captures,
            EncodeGraph.replays - replays) == (1, 2)


def test_sd_batches_on_the_eager_route(monkeypatch):
    """``PerceptualEncoder``, eager on every device: the encode pads its
    last batch to ``batch_size``, as ``svtpu`` does; the decode runs the
    last batch as it is, padded only to a multiple of the data axis."""
    cfg = PerceptualConfig(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2),
                           num_res_blocks=1, compute_dtype="float32",
                           resize_wh=(96, 64))
    torch.manual_seed(0)
    enc = PerceptualEncoder(AutoencoderKL(cfg, device="cpu").state_dict(),
                            cfg, batch_size=4, stochastic=False,
                            device="cpu")
    assert not enc._graphed
    seen = []
    for name in ("encode", "decode"):
        run = getattr(enc.model, name)
        monkeypatch.setattr(enc.model, name, lambda x, run=run, name=name: (
            seen.append((name, len(x))), run(x))[1])
    frames = np.random.default_rng(0).integers(0, 256, (6, 64, 96, 3),
                                               np.uint8)
    z = enc.encode_frames(frames)
    x = enc.decode_latents(z)
    assert z.shape == (6, 32, 48, 4) and x.shape == (6, 64, 96, 3)
    assert seen == [("encode", 4), ("encode", 4), ("decode", 4),
                    ("decode", 2)]


def _uint8_frames():
    return (eval_frames() * 255).round().astype(np.uint8)


def test_bundle_encodes_uint8_frames_as_svtpu():
    """``RBVAEBundle.encode`` of uint8 frames, scaled on the device side of
    the encode (``prep``), against ``svtpu``'s bundle, which scales on the
    host: hard codes bit for bit, noise on at ratio 0 and noise off."""
    from svtpu.evaluation.common import RBVAEBundle as JaxBundle

    jcfg, params, tcfg, sd = eval_model()
    frames = _uint8_frames()
    jb = JaxBundle(cfg=jcfg, params=params, name="m")
    tb = RBVAEBundle(tcfg, sd, name="m", device="cpu")
    for noise in (True, False):
        kw = dict(noise=noise, noise_ratio=0.0, chunk=8, seed=3)
        got = tb.encode(frames, **kw)
        np.testing.assert_array_equal(got, jb.encode(frames, **kw))
        np.testing.assert_array_equal(
            got, tb.encode(frames.astype(np.float32) / 255.0, **kw))


def test_probe_encode_at_two_temperatures_matches_svtpu():
    """One port ``Trainer`` and one ``svtpu`` trainer on the same weights
    and uint8 frames: ``encode_frames`` soft codes (noise on at ratio 0) at
    two temperatures, on the host route and through the staged bank, at
    the forward tests' tolerance; the temperature moves them, and the bank
    route equals the host route bit for bit."""
    from svtpu.config import TrainConfig as JaxTrainConfig
    from svtpu.training.trainer import Trainer as JaxTrainer

    jcfg, params, tcfg, sd = eval_model()
    frames = _uint8_frames()
    splits = split_segments(((0, 10), (10, 20), (20, 30)), 0.2, 0.2)
    kw = dict(batch_size=4, eval_noise_ratio=0.0)
    store = ArrayStore(frames)
    jtr = JaxTrainer(jcfg, JaxTrainConfig(**kw), store, splits, (10, 20))
    tr = Trainer(tcfg, TrainConfig(**kw), store, splits, (10, 20),
                 device="cpu")
    assert tr._bank is not None and not tr._graphed
    model = Seq2SeqBinaryVAE(tcfg, device="cpu")
    model.load_state_dict(sd)
    rows = store.rows(np.arange(30))
    codes = {}
    for temp in (0.4, 1.7):
        enc = dict(hard=False, noise=True, seed=9, chunk=8)
        ref = jtr.encode_frames(params, frames, temp, **enc)
        got = tr.encode_frames(model, frames, temp, **enc)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(
            tr.encode_frames(model, rows, temp, from_bank=True, **enc), got)
        codes[temp] = got
    assert not np.allclose(codes[0.4], codes[1.7], atol=1e-3)
