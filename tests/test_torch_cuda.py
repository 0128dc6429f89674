"""Tests of the port that need an NVIDIA card. They skip without one; on the
card, run them with

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which this file does
not use)."""
import numpy as np
import pytest
import torch

from svtpu_torch.config import TrainConfig, rbvae_variant
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
from svtpu_torch.training.trainer import (Noise, fold_lstm_biases,
                                          pair_objective)


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["contrastive", "simple"])
def test_cpu_model_with_a_card_generator_reads_the_drawn_seed(case):
    """A model on the CPU with a generator on the card: the seed drawn on
    the card reaches the plain sampler whole, even while the card is still
    busy with earlier work when the encode draws it."""
    _require_card()
    geom = {"contrastive": dict(input_hw=(32, 32), conv_features=(8, 8, 8)),
            "simple": dict(input_hw=(16, 16), conv_features=(4, 8, 8))}[case]
    cfg = rbvae_variant(case, 25, pallas_sampler=True, **geom)
    model = Seq2SeqBinaryVAE(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(7).random(
        (5, 2) + cfg.input_hw + (cfg.in_channels,), np.float32))
    scale = 0.1 if cfg.has_noise_ratio else 1.0
    with torch.no_grad():
        torch.cuda._sleep(200_000_000)      # keep the card's stream busy
        got = model.encode(x, 0.5, True, 0.1, deterministic=False,
                           generator=torch.Generator("cuda").manual_seed(11))
        gen = torch.Generator("cuda").manual_seed(11)
        seed = int(torch.randint(2 ** 31 - 1, (1,), generator=gen,
                                 device="cuda"))
        logits = model.encoder_cnn(x.reshape((10,) + x.shape[2:])) \
            .reshape(5, 2, 25)
        t = logits if cfg.binarize == "pre_rnn" else model.encoder_rnn(logits)
        ref = binary_concrete_fused(t, seed, 0.5, scale, True, cfg.bc_eps)
    assert torch.equal(got, ref)


def _train_step(dtype: str, dev: str):
    """The flagship objective's loss and gradients at full width (latent 25,
    256x256, dropout off) in compute dtype ``dtype`` on ``dev``, from seeded
    parameters, frames and uniforms."""
    cfg = rbvae_variant("contrastive", 25, conv_dropout=0.0,
                        compute_dtype=dtype)
    tcfg = TrainConfig(contrast_on="p", contextfree_contrast=True,
                       l1_logits=0.1, margin=3.5, noise_ratio=0.3,
                       beta_kl=0.2, alpha=4.0)
    model = Seq2SeqBinaryVAE(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(4))
    model.to(dev)
    fold_lstm_biases(model)
    B, S = 2, 5
    rng = np.random.default_rng(5)
    batch = torch.from_numpy(rng.integers(0, 256, (B, 2, S, 256, 256, 3),
                                          np.uint8))
    u = {0: rng.random((2 * B, S, 25), np.float32),
         1: rng.random((2 * B * S, 1, 25), np.float32)}
    total, _ = pair_objective(
        model, tcfg, batch.to(dev), 0.9, False,
        Noise(None, dev, {k: torch.from_numpy(v).to(dev)
                          for k, v in u.items()}), deterministic=False)
    total.backward()
    return float(total.detach()), {n: p.grad.cpu() for n, p in
                                   model.named_parameters()
                                   if p.grad is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_step_on_the_card_matches_the_cpu(dtype):
    """With TF32 off, the card's loss within 1e-4 relative of the CPU's; in
    float64 every gradient within 1e-3 of that tensor's largest |grad|. In
    float32 a ReLU input that rounds to the other side of 0 on one device
    drops that element's gradient, and at full width some do, so the
    float32 gradients are held by chip_smoke.py's printout, not here."""
    _require_card()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss_cpu, g_cpu = _train_step(dtype, "cpu")
        loss_card, g_card = _train_step(dtype, "cuda")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    assert set(g_card) == set(g_cpu) and len(g_cpu) > 10
    if dtype == "float64":
        for n, g in g_cpu.items():
            err = float((g_card[n] - g).abs().max())
            assert err <= 1e-3 * float(g.abs().max()), (n, err)


class _Frames:
    """Seeded 32x32 frames with a frame store's interface (row i: frame
    id i)."""

    def __init__(self, n):
        self.array = np.random.default_rng(0).integers(0, 256,
                                                       (n, 32, 32, 3),
                                                       np.uint8)

    def rows(self, idx):
        return np.asarray(idx, np.int64)

    def gather(self, idx):
        return self.array[np.asarray(idx)]


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_step_graph_replays_the_eager_step_bit_for_bit(remat):
    """A tiny contrastive trainer on the card: 8 steps through the step
    graph (2 eager warm-up steps, the capture, replays across anneal
    updates and a raised floor) and 8 through the eager route, from the
    same initial parameters, under deterministic algorithms: every metric,
    parameter and Adam tensor equal."""
    from svtpu_torch.data.segments import split_segments
    from svtpu_torch.training.step_graph import StepGraph
    from svtpu_torch.training.trainer import Trainer

    _require_card()
    cfg = rbvae_variant("contrastive", 6, input_hw=(32, 32),
                        conv_features=(8, 8, 8), remat=remat)
    tcfg = TrainConfig(batch_size=4, num_steps_to_update=2, anneal_rate=0.3,
                       contrast_on="p", contextfree_contrast=True,
                       l1_logits=0.1)
    splits = split_segments(((0, 20), (20, 40), (40, 60)), 0.2, 0.2)
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for graphed in (True, False):
            tr = Trainer(cfg, tcfg, _Frames(60), splits, (20, 40),
                         device="cuda")
            tr._graphed = graphed
            st = tr.init_state()
            replays = StepGraph.replays
            vecs = []
            for i in range(8):
                if i == 5:
                    tr._temp_floor = 1.9
                vec, _ = tr._step(st, torch.from_numpy(next(iter(
                    tr.train_batcher.epoch_indices(i)))).cuda())
                vecs.append(vec.cpu())
            opt = st.optimizer.state_dict()["state"]
            runs.append((vecs, st.model.state_dict(), opt,
                         StepGraph.replays - replays))
    finally:
        torch.use_deterministic_algorithms(False)
    (gv, gp, go, g_replays), (ev, ep, eo, e_replays) = runs
    assert (g_replays, e_replays) == (6, 0)
    assert all(torch.equal(a, b) for a, b in zip(gv, ev))
    assert all(torch.equal(gp[k], ep[k]) for k in ep)
    assert all(torch.equal(go[i][k], eo[i][k]) for i in eo for k in eo[i])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["contrastive", "simple"])
def test_run_frames_graph_equals_eager_bit_for_bit(case):
    """``run_frames`` of a tiny model with both kernels, noise on, four
    batches of one shape on the graph route (the first eager, the second
    captured, then replays) and on the eager route: equal codes batch for
    batch, one capture, and the kernels' launches counted alike."""
    from svtpu_torch.models.encode_graph import EncodeGraph
    from svtpu_torch.ops.cuda_graph import Launches
    from svtpu_torch.pipeline import VideoSymbolPipeline

    _require_card()
    geom = {"contrastive": dict(input_hw=(256, 256)),
            "simple": dict(input_hw=(32, 32), conv_features=(8, 8, 8))}[case]
    cfg = rbvae_variant(case, 25, pallas_trunk=case == "contrastive",
                        pallas_sampler=True, **geom)
    sd = Seq2SeqBinaryVAE(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3)
                          ).state_dict()
    frames = np.random.default_rng(5).integers(
        0, 256, (4, 16) + cfg.input_hw + (3,), np.uint8)
    launches = Launches()
    runs = []
    for graphed in (True, False):
        pipe = VideoSymbolPipeline(cfg, sd, temperature=0.3)
        pipe._graphed = graphed
        before, captures = launches.read(), EncodeGraph.captures
        codes = [pipe.run_frames(f, i) for i, f in enumerate(frames)]
        runs.append((codes, launches.since(before),
                     EncodeGraph.captures - captures))
    (gc, gl, g_captures), (ec, el, e_captures) = runs
    assert (g_captures, e_captures) == (1, 0) and gl == el
    assert all(np.array_equal(a, b) for a, b in zip(gc, ec))


@pytest.mark.cuda
def test_encode_chunks_graph_equals_eager_bit_for_bit():
    """``RBVAEBundle.encode`` of 300 uint8 frames (chunks of 128, the last
    padded), noise on, at two temperatures, soft and hard: the graph route
    equals the eager route, and a new temperature captures nothing."""
    from svtpu_torch.evaluation.common import RBVAEBundle
    from svtpu_torch.models.encode_graph import EncodeGraph

    _require_card()
    cfg = rbvae_variant("contrastive", 25, pallas_trunk=True,
                        pallas_sampler=True)
    sd = Seq2SeqBinaryVAE(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(4)
                          ).state_dict()
    frames = np.random.default_rng(6).integers(0, 256, (300, 256, 256, 3),
                                               np.uint8)
    graphed, eager = RBVAEBundle(cfg, sd), RBVAEBundle(cfg, sd)
    eager._graphed = False
    for hard in (False, True):
        captures = EncodeGraph.captures
        for temp in (0.2, 0.7):
            kw = dict(temperature=temp, hard=hard, noise=True, seed=2)
            assert np.array_equal(graphed.encode(frames, **kw),
                                  eager.encode(frames, **kw))
        assert EncodeGraph.captures - captures == 1


@pytest.fixture(scope="module")
def hd_requests():
    """Four seeded batches of 64 uint8 720x1280 frames (177 MB each), each
    frame a coarse random image upsampled, plus fine noise."""
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for _ in range(4):
        coarse = torch.rand((64, 3, 9, 16), generator=gen, device="cuda")
        x = torch.nn.functional.interpolate(coarse, size=(720, 1280),
                                            mode="bilinear")
        x = x * 200 + torch.rand(x.shape, generator=gen, device="cuda") * 55
        out.append(x.to(torch.uint8).permute(0, 2, 3, 1).contiguous()
                   .cpu().numpy())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [True, False], ids=["noisy", "noise-off"])
@pytest.mark.parametrize("memory", ["pinned", "pageable"])
def test_run_frames_chunked_copy_equals_one_chunk_bit_for_bit(
        hd_requests, memory, noise, monkeypatch):
    """Four requests of 64 HD frames through one host buffer, overwritten
    with other frames as soon as each ``run_frames`` returns: the chunked
    graph route's codes equal the one-chunk graph route's and the eager
    route's bit for bit, request for request; ``copy_chunks`` counts the
    rule's chunks a request; ``drop_graphs()`` frees the staging buffers.
    And ``preprocess`` gives ``resize_bilinear(to_float01(x))``'s numbers
    on the card."""
    from svtpu_torch import pipeline
    from svtpu_torch.ops.image import resize_bilinear, to_float01
    from svtpu_torch.pipeline import VideoSymbolPipeline, frame_chunks

    x = torch.from_numpy(hd_requests[0][:8]).cuda()
    assert torch.equal(pipeline.preprocess(x, (256, 256)),
                       resize_bilinear(to_float01(x), (256, 256)))

    cfg = rbvae_variant("contrastive", 25, pallas_trunk=True,
                        pallas_sampler=True)
    sd = Seq2SeqBinaryVAE(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(7)
                          ).state_dict()
    # The benchmark's gains (``weight_gains``): codes that follow the
    # frames with the noise off too.
    for name, gain in (("encoder_cnn.conv.", 6 ** 0.5),
                       ("encoder_cnn.fc.", 3 ** 0.5)):
        for key in sd:
            if key.startswith(name) and key.endswith("weight"):
                sd[key] = sd[key] * gain
    shape = hd_requests[0].shape
    buf = torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy() \
        if memory == "pinned" else np.empty(shape, np.uint8)
    k = len(frame_chunks(shape[0], buf.nbytes))
    assert k == pipeline.COPY_CHUNKS

    def serve(pipe):
        out = []
        for i, frames in enumerate(hd_requests):
            buf[...] = frames
            out.append(pipe.run_frames(buf, i))
            buf[...] = 255 - frames
        return out

    def make():
        return VideoSymbolPipeline(cfg, sd, temperature=0.3, noise=noise)

    chunked = make()
    before = VideoSymbolPipeline.copy_chunks
    got = serve(chunked)
    assert VideoSymbolPipeline.copy_chunks - before == k * len(hd_requests)
    eager = make()
    eager._graphed = False
    want = serve(eager)
    with monkeypatch.context() as m:
        m.setattr(pipeline, "COPY_CHUNK_BYTES", buf.nbytes)
        one = make()
        before = VideoSymbolPipeline.copy_chunks
        whole = serve(one)
        assert VideoSymbolPipeline.copy_chunks == before
    for i in range(len(hd_requests)):
        assert np.array_equal(got[i], want[i]), i
        assert np.array_equal(whole[i], want[i]), i
    # Requests, and frames within one, have codes of their own.
    assert len({c.tobytes() for c in want}) == len(want)
    assert len({row.tobytes() for row in want[0]}) > 1
    # The graphs first, then what drop_graphs frees beside them.
    super(VideoSymbolPipeline, chunked).drop_graphs()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    chunked.drop_graphs()
    assert not chunked._staging
    assert held - torch.cuda.memory_allocated() \
        >= buf.nbytes + shape[0] * 256 * 256 * 3 * 4


@pytest.mark.cuda
def test_flash_attention_at_the_vit_shape():
    """``flash_attention`` at V-JEPA 2's ``[clips * heads, tokens,
    head_dim]`` = ``[32, 8192, 64]`` in bf16 (``d64::flash_bf16_kernel``)
    against ``blocked_attention`` in f32 with TF32 off: within two bf16
    steps at the output's scale (p is rounded to bf16 in the kernel, not
    in the plain version), scores spread wide (std 3)."""
    from svtpu_torch.ops.attention import (blocked_attention,
                                           flash_attention, kernel_for)

    _require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn((32, 8192, 64), generator=gen, device="cuda")
               for _ in range(3))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    assert kernel_for(torch.bfloat16, 64) == "bf16_d64"
    before = dict(flash_attention.launches_by_kernel)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = flash_attention.launches_by_kernel
    assert after["bf16_d64"] == before["bf16_d64"] + 1
    assert after["bf16"] == before["bf16"]
    want = blocked_attention(q, k, v).float()
    step = 2.0 ** -7 * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 2 * step


def _d64_inputs(B, N, seed, spread=1.0, dominant=False):
    """bf16 q, k, v [B, N, 64] on the card; ``spread`` is the scores'
    variance, ``dominant`` gives each query one key whose score stands
    ~``4 sqrt(D)`` above the rest (a wrong running-max rescale shows)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, N, 64, generator=g) for _ in range(3))
    q, k = q * spread ** 0.5, k * spread ** 0.5
    if dominant:
        perm = torch.randperm(N, generator=g)
        k[:, perm] = 4.0 * q / q.norm(dim=-1, keepdim=True) * 8.0 \
            + 0.1 * k[:, perm]
    return [t.cuda().bfloat16() for t in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged 1000", "ragged 8191",
                                  "dominant key", "spread 8", "B = 1",
                                  "graph replay"])
def test_flash_attention_d64_cases(case):
    """The D = 64 kernel against ``blocked_attention`` (f32, TF32 off),
    within two bf16 steps at the output's scale: N ragged against its
    192-row blocks and 128-key tiles, one dominant key a row, scores spread
    wide (std 8), a single slice; and two launches captured in one CUDA
    graph, whose replay equals eager launches on the same inputs bit for
    bit (the TMA maps travel in the captured parameters)."""
    from svtpu_torch.ops.attention import blocked_attention, flash_attention

    _require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, kw = {"ragged 1000": (3, 1000, dict(spread=8.0)),
                "ragged 8191": (2, 8191, {}),
                "dominant key": (2, 4000, dict(dominant=True)),
                "spread 8": (4, 2048, dict(spread=8.0)),
                "B = 1": (1, 1536, {}),
                "graph replay": (4, 3000, dict(spread=4.0))}[case]
    qkv = _d64_inputs(B, N, seed=len(case) + N, **kw)
    before = flash_attention.launches_by_kernel["bf16_d64"]
    if case == "graph replay":
        other = [t.flip(1).contiguous() for t in qkv]
        eager = [flash_attention(*qkv), flash_attention(*other)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            flash_attention(*qkv)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [flash_attention(*qkv), flash_attention(*other)]
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
        assert flash_attention.launches_by_kernel["bf16_d64"] - before == 5
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)
        got = outs[0]
    else:
        got = flash_attention(*qkv)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_kernel["bf16_d64"] == before + 1
    want = blocked_attention(*qkv).float()
    assert got.shape == (B, N, 64) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    step = 2.0 ** -7 * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 2 * step


@pytest.fixture(scope="module")
def clip_requests():
    """Three batches of 70 uint8 360x640 frames (two clips, the second
    padded with 58 copies of frame 69), page-locked."""
    _require_card()
    rng = np.random.default_rng(12)
    out = []
    for _ in range(3):
        buf = torch.empty((70, 360, 640, 3), dtype=torch.uint8,
                          pin_memory=True)
        buf.copy_(torch.from_numpy(rng.integers(0, 256, buf.shape,
                                                np.uint8)))
        out.append(buf.numpy())
    return out


@pytest.mark.cuda
def test_clip_encoder_graph_equals_eager_bit_for_bit(clip_requests):
    """V-JEPA 2's encoder at its published widths (seeded weights) through
    ``ClipEncoder.encode_frames``, three requests on the graph route (the
    first eager, the second captured, then a replay) and on the eager
    route: equal features request for request, one capture, a
    ``d64::flash_bf16_kernel`` launch a layer and request (none of the
    mma.sync kernel); then ``run_frames``
    of a percep RBVAE over the features on both routes: equal codes, a
    tubelet's code on both of its frames."""
    from svtpu_torch.config import VJEPA2Config
    from svtpu_torch.models.encode_graph import EncodeGraph
    from svtpu_torch.models.vjepa2 import VJEPA2
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.perceptual.clip import ClipEncoder
    from svtpu_torch.pipeline import VideoSymbolPipeline

    _require_card()
    cfg = VJEPA2Config()
    params = VJEPA2(cfg, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(8)
                    ).state_dict()
    graphed, eager = (ClipEncoder(params, cfg) for _ in range(2))
    eager._graphed = False
    captures = EncodeGraph.captures
    for frames in clip_requests:
        before = dict(flash_attention.launches_by_kernel)
        got = graphed.encode_frames(frames).clone()
        after = flash_attention.launches_by_kernel
        assert after["bf16_d64"] - before["bf16_d64"] == cfg.num_hidden_layers
        assert after["bf16"] == before["bf16"]
        want = eager.encode_frames(frames)
        assert got.shape == (64, 16, 16, 1024) and got.dtype == torch.bfloat16
        assert torch.equal(got, want)
    assert EncodeGraph.captures - captures == 1

    rb = rbvae_variant("percep", 25, lstm_residual=True, in_channels=1024,
                       out_channels=1024, input_hw=(16, 16),
                       compute_dtype="bfloat16", pallas_sampler=True)
    sd = Seq2SeqBinaryVAE(rb, device="cpu",
                          generator=torch.Generator().manual_seed(9)
                          ).state_dict()
    codes = []
    for enc in (graphed, eager):
        pipe = VideoSymbolPipeline(rb, sd, percep=enc, temperature=0.3)
        pipe._graphed = enc._graphed
        codes.append([pipe.run_frames(f, i)
                      for i, f in enumerate(clip_requests)])
    for g, e in zip(*codes):
        assert g.shape == (70, 25) and np.array_equal(g, e)
        assert np.array_equal(g[0::2], g[1::2])


@pytest.mark.cuda
def test_rope_tables_built_once(clip_requests):
    """The rotary tables are built when the encoder is, once, on the card,
    and no encode (eager, captured or replayed) builds them again."""
    from svtpu_torch.config import VJEPA2Config
    from svtpu_torch.models.vjepa2 import VJEPA2
    from svtpu_torch.ops.rope import rope_tables
    from svtpu_torch.perceptual.clip import ClipEncoder

    _require_card()
    cfg = VJEPA2Config(num_hidden_layers=1)
    params = VJEPA2(cfg, device="cuda").state_dict()
    before = rope_tables.builds
    enc = ClipEncoder(params, cfg)
    assert rope_tables.builds == before + 1
    assert enc.model.rope_cos.device.type == "cuda"
    assert enc.model.rope_cos.dtype == torch.float32
    for frames in clip_requests:
        enc.encode_frames(frames)
    torch.cuda.synchronize()
    assert rope_tables.builds == before + 1


@pytest.mark.cuda
def test_percep_resize_on_the_card(hd_requests):
    """The card's ``resize_u8`` of seeded 720x1280 frames to the SD input,
    704x1280, lies within one grey level of the host's, with at least 99%
    of pixels equal. A tiny SD first stage's ``run_frames`` on the card
    hands ``encode_frames`` the frames resized on the card and adds one to
    ``PerceptualEncoder.resizes`` a request, and none for frames already at
    the SD input; ``encode_frames`` gives those frames, on the card or
    from the host, the same latents bit for bit, a batch padded on the
    card too."""
    from svtpu_torch.config import PerceptualConfig
    from svtpu_torch.models.autoencoder_kl import AutoencoderKL
    from svtpu_torch.ops.image import resize_u8
    from svtpu_torch.perceptual.embed import PerceptualEncoder
    from svtpu_torch.pipeline import VideoSymbolPipeline

    requests = [f[:8] for f in hd_requests[:3]]
    x = torch.from_numpy(requests[0])
    host = resize_u8(x, (704, 1280))
    card = resize_u8(x.cuda(), (704, 1280))
    assert card.device.type == "cuda" and card.dtype == torch.uint8
    diff = (card.cpu().int() - host.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.99

    cfg = PerceptualConfig(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2),
                           num_res_blocks=1, compute_dtype="float32",
                           resize_wh=(96, 64))
    ae = AutoencoderKL(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(5)).state_dict()
    enc = PerceptualEncoder(ae, cfg, batch_size=8, seed=3)
    seen = []
    encode = enc.encode_frames
    enc.encode_frames = lambda f: seen.append(f) or encode(f)
    rb = rbvae_variant("percep", 25, lstm_residual=True, input_hw=(32, 48),
                       conv_features=(16, 16, 16), pallas_sampler=True)
    sd = Seq2SeqBinaryVAE(rb, device="cpu",
                          generator=torch.Generator().manual_seed(6)
                          ).state_dict()
    pipe = VideoSymbolPipeline(rb, sd, percep=enc, temperature=0.3)
    before = PerceptualEncoder.resizes
    for i, frames in enumerate(requests):
        codes = pipe.run_frames(frames, i)
        assert PerceptualEncoder.resizes == before + i + 1
        assert codes.shape == (8, 25) and set(np.unique(codes)) <= {0, 1}
    assert all(f.device.type == "cuda" and f.dtype == torch.uint8
               and f.shape == (8, 64, 96, 3) for f in seen)
    on_card = seen[-1]
    pipe.run_frames(on_card.cpu().numpy(), 9)
    assert PerceptualEncoder.resizes == before + len(requests)
    for f in (on_card, on_card[:5]):
        assert np.array_equal(encode(f), encode(f.cpu().numpy()))


# The attention shapes of one 1024x1024 frame of SAM 2.1 Hiera-L at D = 72,
# each on a few windows' worth of grid: (key grid side, key window (0:
# global), queries pooled 2x2, heads) → per frame (windows x heads, Nq,
# Nk) of the cell: stage 1, the pooled first blocks of stages 2-4, the
# windowed blocks of stages 2-4 and stage 3's global blocks.
SAM2_SHAPES = {"(2048, 64, 64)": (32, 8, False, 2),
               "(4096, 16, 64)": (32, 8, True, 4),
               "(4096, 16, 16)": (16, 4, False, 4),
               "(8192, 4, 16)": (16, 4, True, 8),
               "(128, 256, 256)": (32, 16, False, 8),
               "(8, 4096, 4096)": (64, 0, False, 8),
               "(256, 64, 256)": (32, 16, True, 16),
               "(256, 64, 64)": (16, 8, False, 16)}


def _within_two_steps(got, want):
    step = 2.0 ** -7 * float(want.abs().max())
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - want).abs().max()) <= 2 * step


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SAM2_SHAPES))
def test_window_attention_at_the_cell_shapes(shape):
    """``window_attention`` on the card (``window_attn_kernel``, global:
    ``flash_d72_kernel``) reading q, k and v in place from one bf16 qkv
    grid ``[2, S, S, 3 C]`` (token stride ``3 C``), the queries max-pooled
    2x2 where the block pools them, against the plain version in f32 with
    TF32 off: within two bf16 steps at the output's scale, scores spread
    (std ~2); one launch counted under the route's key, none under
    ``bf16``."""
    from svtpu_torch.ops.attention import (flash_attention, window_attention,
                                           window_attention_plain)

    _require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    side, window, pooled, heads = SAM2_SHAPES[shape]
    C = 72 * heads
    g = torch.Generator().manual_seed(side * 7 + heads)
    qkv = torch.randn(2, side, side, 3 * C, generator=g)
    qkv[..., :C] *= 2.0
    qkv = qkv.cuda().bfloat16()
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    if pooled:
        q = q.reshape(2, side // 2, 2, side // 2, 2, C).amax(dim=(2, 4))
    key = "bf16_d72" if window == 0 else "bf16_d72_window"
    before = dict(flash_attention.launches_by_kernel)
    got = window_attention(q, k, v, heads, window)
    torch.cuda.synchronize()
    after = flash_attention.launches_by_kernel
    assert after[key] == before[key] + 1 and after["bf16"] == before["bf16"]
    want = window_attention_plain(q.float(), k.float(), v.float(), heads,
                                  window)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _within_two_steps(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged 1000", "Nq 37 Nk 150",
                                  "Nq 16 Nk 64", "dominant key",
                                  "graph replay"])
def test_flash_attention_d72_cases(case):
    """``flash_attention`` at D = 72 (``flash_d72_kernel``) on ``[B, N,
    72]`` against ``blocked_attention`` (f32, TF32 off), within two bf16
    steps: N ragged against the 64-row blocks and 64-key tiles, fewer
    queries than keys (one block spanning several rows of the batch), one
    dominant key a row (a wrong running-max rescale shows); and two
    launches captured in one CUDA graph whose replay equals eager launches
    bit for bit."""
    from svtpu_torch.ops.attention import blocked_attention, flash_attention

    _require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, nq, nk = {"ragged 1000": (3, 1000, 1000), "Nq 37 Nk 150": (5, 37, 150),
                 "Nq 16 Nk 64": (40, 16, 64), "dominant key": (2, 700, 700),
                 "graph replay": (4, 300, 1200)}[case]
    g = torch.Generator().manual_seed(nq + nk)
    q = torch.randn(B, nq, 72, generator=g) * 1.5
    k, v = (torch.randn(B, nk, 72, generator=g) for _ in range(2))
    if case == "dominant key":
        k[:, torch.randperm(nk, generator=g)] = 4.0 * q / q.norm(
            dim=-1, keepdim=True) * 72 ** 0.5
    q, k, v = (t.cuda().bfloat16() for t in (q, k, v))
    before = flash_attention.launches_by_kernel["bf16_d72"]
    if case == "graph replay":
        other = (q.flip(1).contiguous(), k, v)
        eager = [flash_attention(q, k, v), flash_attention(*other)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            flash_attention(q, k, v)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [flash_attention(q, k, v), flash_attention(*other)]
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
        assert flash_attention.launches_by_kernel["bf16_d72"] - before == 5
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)
        got = outs[0]
    else:
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_kernel["bf16_d72"] == before + 1
    assert got.shape == (B, nq, 72) and got.dtype == torch.bfloat16
    _within_two_steps(got, blocked_attention(q, k, v).float())


@pytest.mark.cuda
def test_sam2_encoder_graph_equals_eager_bit_for_bit():
    """SAM 2.1's image encoder at its published widths (seeded weights)
    through ``Sam2Encoder.encode_frames``, three requests of 6 page-locked
    360x640 frames on the graph route (the first eager, the second
    captured, then a replay) and on the eager route: equal features
    request for request, one capture, 45 windowed and 3 global D = 72
    launches a request (none of the mma.sync kernel), the position table
    built once an encoder; then ``run_frames`` of a percep RBVAE over the
    features on both routes: equal codes, one a frame."""
    from svtpu_torch.config import Sam2HieraConfig
    from svtpu_torch.models import sam2
    from svtpu_torch.models.encode_graph import EncodeGraph
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.perceptual.sam2 import Sam2Encoder
    from svtpu_torch.pipeline import VideoSymbolPipeline

    _require_card()
    cfg = Sam2HieraConfig()
    params = sam2.Sam2ImageEncoder(
        cfg, device="cuda",
        generator=torch.Generator("cuda").manual_seed(8)).state_dict()
    builds = sam2.pos_table.builds
    graphed, eager = (Sam2Encoder(params, cfg) for _ in range(2))
    assert sam2.pos_table.builds == builds + 2
    eager._graphed = False
    rng = np.random.default_rng(13)
    requests = []
    for _ in range(3):
        buf = torch.empty((6, 360, 640, 3), dtype=torch.uint8,
                          pin_memory=True)
        buf.copy_(torch.from_numpy(rng.integers(0, 256, buf.shape,
                                                np.uint8)))
        requests.append(buf.numpy())
    captures = EncodeGraph.captures
    for frames in requests:
        before = dict(flash_attention.launches_by_kernel)
        got = graphed.encode_frames(frames).clone()
        after = flash_attention.launches_by_kernel
        assert after["bf16_d72_window"] - before["bf16_d72_window"] == 45
        assert after["bf16_d72"] - before["bf16_d72"] == 3
        assert after["bf16"] == before["bf16"]
        want = eager.encode_frames(frames)
        assert got.shape == (6, 64, 64, 256) and got.dtype == torch.bfloat16
        assert torch.equal(got, want)
    assert EncodeGraph.captures - captures == 1
    assert sam2.pos_table.builds == builds + 2

    rb = rbvae_variant("percep", 25, lstm_residual=True, in_channels=256,
                       out_channels=256, input_hw=(64, 64),
                       compute_dtype="bfloat16", pallas_sampler=True)
    sd = Seq2SeqBinaryVAE(rb, device="cpu",
                          generator=torch.Generator().manual_seed(9)
                          ).state_dict()
    codes = []
    for enc in (graphed, eager):
        pipe = VideoSymbolPipeline(rb, sd, percep=enc, temperature=0.3)
        pipe._graphed = enc._graphed
        codes.append([pipe.run_frames(f, i) for i, f in enumerate(requests)])
    for g, e in zip(*codes):
        assert g.shape == (6, 25) and np.array_equal(g, e)


# The SD encoder's norms at the percep cell's size, [8, C, H, W]: (C, H,
# W, SiLU). The first norms of levels 1 and 2 take the previous level's
# width; the mid block's attention norm has no SiLU.
GN_SHAPES = {"level 0": (128, 704, 1280, True),
             "level 1, first norm": (128, 352, 640, True),
             "level 1": (256, 352, 640, True),
             "level 2, first norm": (256, 176, 320, True),
             "level 2": (512, 176, 320, True),
             "level 3": (512, 88, 160, True),
             "mid attention": (512, 88, 160, False)}


def _gn_inputs(c, h, w, dt, seed):
    """A channels-last ``[8, c, h, w]`` activation with a mean and scale a
    channel, and float32 weight and bias, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shift = torch.randn(c, generator=g, device="cuda") * 2.0
    scale = torch.rand(c, generator=g, device="cuda") * 2.0 + 0.25
    x = torch.randn((8, h, w, c), generator=g, device="cuda") * scale + shift
    return (x.to(dt).permute(0, 3, 1, 2),
            torch.rand(c, generator=g, device="cuda") + 0.5,
            torch.randn(c, generator=g, device="cuda") * 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", list(GN_SHAPES))
def test_group_norm_silu_at_the_cell_shapes(shape, dtype):
    """``group_norm_silu`` on the card against its plain version: bf16
    within two bf16 steps at the output's largest magnitude, f32 within
    1e-5 of it; two launches bit for bit, each counted; channels-last
    out."""
    _require_card()
    from svtpu_torch.ops.group_norm import (group_norm_silu,
                                            group_norm_silu_plain)

    c, h, w, silu = GN_SHAPES[shape]
    dt = getattr(torch, dtype)
    x, weight, bias = _gn_inputs(c, h, w, dt, c + h)
    before = group_norm_silu.launches
    with torch.inference_mode():
        got = group_norm_silu(x, weight, bias, 1e-6, silu, dt)
        again = group_norm_silu(x, weight, bias, 1e-6, silu, dt)
        want = group_norm_silu_plain(x, weight, bias, 1e-6, silu, dt).float()
    assert group_norm_silu.launches == before + 2
    assert got.dtype == dt and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, again)
    if dt == torch.bfloat16:
        _within_two_steps(got, want)
    else:
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_group_norm_silu_layouts_and_refusals():
    """An NCHW input is made channels-last first (the same bits), and
    weights held as ``nn.Parameter``s give the tensors' bits; the card's
    route refuses float16, a change of dtype and a tensor that
    needs a gradient, and launches nothing for them."""
    _require_card()
    from svtpu_torch.ops.group_norm import group_norm_silu

    x, weight, bias = _gn_inputs(256, 40, 72, torch.bfloat16, 3)
    with torch.inference_mode():
        cl = group_norm_silu(x, weight, bias, 1e-6, True, torch.bfloat16)
        nchw = group_norm_silu(x.contiguous(), weight, bias, 1e-6, True,
                               torch.bfloat16)
    assert torch.equal(cl, nchw)
    held = [torch.nn.Parameter(t.clone()) for t in (weight, bias)]
    with torch.inference_mode():
        assert torch.equal(cl, group_norm_silu(x, *held, 1e-6, True,
                                               torch.bfloat16))
    before = group_norm_silu.launches
    with pytest.raises(TypeError):
        group_norm_silu(x.half(), weight, bias, 1e-6, True, torch.float16)
    with pytest.raises(TypeError):
        group_norm_silu(x, weight, bias, 1e-6, True, torch.float32)
    with pytest.raises(RuntimeError):
        group_norm_silu(x, weight.requires_grad_(), bias, 1e-6, True,
                        torch.bfloat16)
    assert group_norm_silu.launches == before


@pytest.mark.cuda
def test_sd_encoder_on_the_card_matches_the_cpu():
    """An SD encoder at widths 128-256-512 with seeded norm weights, its
    norms through the kernel on the card (12 launches), against the same
    model on the CPU: float32, TF32 off, within 1e-4 of the moments'
    largest magnitude."""
    _require_card()
    from svtpu_torch.config import PerceptualConfig
    from svtpu_torch.models.autoencoder_kl import AutoencoderKL, GroupNormSiLU
    from svtpu_torch.ops.group_norm import group_norm_silu

    cfg = PerceptualConfig(embed_dim=4, z_channels=4, ch=128,
                           ch_mult=(1, 2, 4), num_res_blocks=1,
                           compute_dtype="float32")
    cpu = AutoencoderKL(cfg, device="cpu", use_kernel=False,
                        generator=torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(9)
    sd = cpu.state_dict()
    norms = [n for n, m in cpu.encoder.named_modules()
             if isinstance(m, GroupNormSiLU)]
    for n in norms:
        sd[f"encoder.{n}.weight"] = torch.rand(sd[f"encoder.{n}.weight"]
                                               .shape, generator=g) + 0.5
        sd[f"encoder.{n}.bias"] = torch.randn(sd[f"encoder.{n}.bias"].shape,
                                              generator=g)
    cpu.load_state_dict(sd)
    card = AutoencoderKL(cfg, device="cuda", use_kernel=False)
    card.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, (2, 48, 80, 3)).astype(np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = cpu.encode(x)
            before = group_norm_silu.launches
            got = card.encode(x.cuda()).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert len(norms) == 12 and group_norm_silu.launches == before + 12
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
