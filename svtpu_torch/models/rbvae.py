"""Recurrent Binary VAE — one parameterized module covering the four
reference variants (simple, contrastive, percep, triplet); the port of
``svtpu/models/rbvae.py:41-256``.

Public layout is the JAX package's: frames ``[B, T, H, W, C]`` in, latents
``[B, T, L]`` out, reconstructions ``[B, T, H, W, C]``. Inside, the conv
stacks run NCHW (channels-last memory) on torch's own layouts, and the
parameters carry the reference torch state-dict names
(``encoder_cnn.conv.{0,3,6}``, ``encoder_cnn.fc``, ``decoder_cnn.fc``,
``decoder_cnn.deconv.{0,3,6}``, ``{encoder,decoder}_rnn.lstm.*``), so a
reference ``.pt`` state dict loads as it is.

``encode`` routes through the hand-written kernels when the config asks for
them, as the JAX package routes through its Pallas kernels:
``pallas_trunk`` → ``ops/conv_trunk_cuda.py`` (conv0+conv1),
``pallas_sampler`` → ``ops/lstm_cuda.py`` (the encoder LSTM and the sampler
in one kernel) where the variant binarizes after the LSTM and the kernel
takes its LSTM (latent <= 64), and ``ops/binarize_cuda.py`` (the sampler
alone) where it binarizes before it (simple) or after a wider LSTM, which
runs as plain ops. The kernels' noise seed is drawn from the generator on its own
device and stays there, so the host never waits for it.
``int8_trunk`` (where ``pallas_trunk`` is off: the kernel wins, as in
``svtpu``) runs every conv of the encoder but conv0 through
``ops/conv.py::conv2d_int8``, inference only. ``conv0_s2d`` (conv0 of
every pass, on the plain trunk) and ``deconv_d2s`` (every decoder stage)
are exact rewrites of the same parameters, gradients included.

``forward`` with ``deterministic=False`` is the training pass: dropout
between the encoder's convs and between the decoder's transposed convs, as
in the reference, on the plain trunk and sampler (the kernels have no
backward, as in the JAX package). ``cfg.remat`` recomputes the conv
encoder's and decoder's activations in the backward pass
(``torch.utils.checkpoint``).

Randomness is explicit: Binary-Concrete noise comes from a
``torch.Generator`` (or an injected uniform ``u``), dropout masks from
generators seeded by a host int (``dropout_seed``) inside the conv stacks,
so that a recompute under ``remat`` draws the same masks (checkpointing
restores only the global generators' states), or from the trainer's
persistent generators (``draws.Replicas``: the recompute takes a replica
of its own, seeded alike), and the initial weights from the generator given
to the constructor.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from svtpu_torch import batch_seed, resolve_device
from svtpu_torch.config import RBVAEConfig
from svtpu_torch.ops import draws
from svtpu_torch.ops.binarize import binary_concrete
from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
from svtpu_torch.ops.conv import (Conv2dTorch, ConvTranspose2dTorch, Dense,
                                  conv2d_int8)
from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
from svtpu_torch.ops.lstm import LSTM
from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete, takes


# A pass's dropout masks: a host int that seeds them, or the train step's
# persistent generators (``_dropout_generator``); ``None`` for no dropout.
DropoutSeed = Optional[Union[int, Sequence[draws.Replicas]]]


class RBVAEOutput(NamedTuple):
    x_recon: torch.Tensor     # [B, T, H, W, C]
    h_seq: torch.Tensor       # [B, T, L] encoder-LSTM output (post-binarize
    #                           z for the simple variant)
    z_seq: torch.Tensor       # [B, T, L] binarized latents
    logits: torch.Tensor      # [B, T, L] conv-encoder logits


def _dropout(h: torch.Tensor, rate: float,
             gen: draws.Source) -> torch.Tensor:
    """Keep each value with probability ``1 - rate`` and scale the kept
    ones by ``1 / (1 - rate)``, as flax's Dropout does; the mask comes from
    ``gen`` (``F.dropout`` takes no generator)."""
    keep = 1.0 - rate
    mask = draws.rand(h.shape, gen, device=h.device) < keep
    return torch.where(mask, h / keep, 0.0)


def _dropout_generator(cfg: RBVAEConfig, dropout_seed: DropoutSeed,
                       stage: int, device,
                       rows: Optional[draws.GlobalRows] = None):
    """The generator of one conv stack's masks (stage 0 the encoder, 1 the
    decoder), drawing at ``rows`` of the global batch where given, or
    ``None`` for no dropout. ``dropout_seed``: an int, from which each call
    seeds a fresh generator with ``batch_seed(dropout_seed, stage)``; or a
    train step's persistent generators, one ``draws.Replicas`` a stage,
    seeded so by the trainer."""
    if dropout_seed is None or cfg.conv_dropout == 0:
        return None
    if isinstance(dropout_seed, int):
        gen = torch.Generator(device=device)
        gen.manual_seed(batch_seed(dropout_seed, stage))
    else:
        gen = dropout_seed[stage].take()
    return draws.sharded(gen, rows)


def _stack(cfg: RBVAEConfig, convs, final_relu: bool) -> nn.Sequential:
    """The reference's ``nn.Sequential``: conv, ReLU (+ Dropout) between
    stages, so the conv indices are {0,3,6} with dropout and {0,2,4}
    without, as in the reference state dicts."""
    layers, n = [], len(convs)
    for i, conv in enumerate(convs):
        layers.append(conv)
        if i < n - 1 or final_relu:
            layers.append(nn.ReLU())
        if i < n - 1 and cfg.conv_dropout > 0:
            layers.append(nn.Dropout(cfg.conv_dropout))
    return nn.Sequential(*layers)


class ConvEncoder(nn.Module):
    def __init__(self, cfg: RBVAEConfig):
        super().__init__()
        self.cfg = cfg
        k, s, p = cfg.conv_kernel, cfg.conv_stride, cfg.conv_padding
        chans = (cfg.in_channels,) + tuple(cfg.conv_features)
        self.conv = _stack(cfg, [Conv2dTorch(chans[i], chans[i + 1], k, s, p)
                                 for i in range(len(cfg.conv_features))],
                           cfg.conv_final_relu)
        self.fc = Dense(cfg.encoded_dim, cfg.latent_dim)

    def convs(self) -> list[Conv2dTorch]:
        return [m for m in self.conv if isinstance(m, Conv2dTorch)]

    def forward(self, x: torch.Tensor, trunk: str = "torch",
                dropout_seed: DropoutSeed = None,
                rows: Optional[draws.GlobalRows] = None) -> torch.Tensor:
        """``x [N, H, W, C]`` → logits ``[N, L]``: ``features``, then fc."""
        h = self.features(x, trunk, dropout_seed, rows)
        # Flatten in torch's channel-major order, which the fc weight uses.
        # The dtype goes by keyword: a tensor-parallel style's input hook
        # passes the first positional argument alone.
        return self.fc(h.reshape(h.shape[0], -1),
                       dtype=self.cfg.torch_dtype)

    def features(self, x: torch.Tensor, trunk: str = "torch",
                 dropout_seed: DropoutSeed = None,
                 rows: Optional[draws.GlobalRows] = None) -> torch.Tensor:
        """``x [N, H, W, C]`` → the conv stack's output ``[N, C', H', W']``
        in the compute dtype.

        ``trunk``: "torch" (library convs; conv0 by space-to-depth under
        ``cfg.conv0_s2d``), "kernel" (the fused conv0+conv1 kernel, then
        conv2 as a library conv; 256x256 contrastive/triplet geometry only;
        inference) or "int8" (conv0 in the compute dtype, the others by
        ``conv2d_int8``; inference). ``dropout_seed``: dropout between the
        convs, masks drawn from a generator seeded by it; ``None`` for none.
        ``rows``: the masks' rows of a global batch (``ops/draws.py``).
        """
        c = self.cfg
        dt = c.torch_dtype
        convs = self.convs()
        n = len(convs)
        h = x.to(dt)
        gen = _dropout_generator(c, dropout_seed, 0, x.device, rows)
        if trunk == "kernel":
            if gen is not None:
                raise ValueError("the trunk kernel is inference-only: no "
                                 "dropout")
            if not (c.conv_features == (64, 64, 64) and c.in_channels == 3
                    and (c.conv_kernel, c.conv_stride, c.conv_padding)
                    == (3, 2, 1) and tuple(h.shape[1:3]) == (256, 256)):
                raise ValueError("the fused trunk kernel supports only the "
                                 "contrastive/triplet pixel geometry")
            h = fused_conv01(h.contiguous(), convs[0].weight, convs[0].bias,
                             convs[1].weight, convs[1].bias)
            h = convs[2](h.permute(0, 3, 1, 2), dt)
            if c.conv_final_relu:
                h = h.relu()
        elif trunk == "int8":
            if gen is not None or (torch.is_grad_enabled() and any(
                    p.requires_grad for p in self.conv.parameters())):
                raise ValueError("the int8 trunk is inference-only: no "
                                 "dropout, no gradient (run it under "
                                 "torch.no_grad())")
            h = h.permute(0, 3, 1, 2)
            for i, conv in enumerate(convs):
                h = conv(h, dt) if i == 0 else conv2d_int8(
                    h, conv.weight, conv.bias, conv.stride[0],
                    conv.padding[0], dt)
                if i < n - 1 or c.conv_final_relu:
                    h = h.relu()
        elif trunk == "torch":
            h = h.permute(0, 3, 1, 2)
            for i, conv in enumerate(convs):
                h = conv(h, dt, s2d=i == 0 and c.conv0_s2d)
                if i < n - 1 or c.conv_final_relu:
                    h = h.relu()
                if i < n - 1 and gen is not None:
                    h = _dropout(h, c.conv_dropout, gen)
        else:
            raise ValueError(f"unknown trunk {trunk!r}")
        return h


class ConvDecoder(nn.Module):
    def __init__(self, cfg: RBVAEConfig):
        super().__init__()
        self.cfg = cfg
        k, s, p = cfg.conv_kernel, cfg.conv_stride, cfg.conv_padding
        feats = tuple(reversed(cfg.conv_features))
        eh, ew = cfg.encoded_hw
        self.fc = Dense(cfg.latent_dim, feats[0] * eh * ew)
        # output_padding makes every stage exactly double H and W.
        op = 1 if k == 3 else 0
        chans = feats + (cfg.out_channels,)
        self.deconv = _stack(
            cfg, [ConvTranspose2dTorch(chans[i], chans[i + 1], k, s, p, op)
                  for i in range(len(feats))], False)

    def forward(self, z: torch.Tensor,
                dropout_seed: DropoutSeed = None,
                rows: Optional[draws.GlobalRows] = None) -> torch.Tensor:
        """``z [N, L]`` → ``[N, H, W, C]``; ``dropout_seed`` and ``rows`` as
        the encoder's."""
        c = self.cfg
        dt = c.torch_dtype
        eh, ew = c.encoded_hw
        gen = _dropout_generator(c, dropout_seed, 1, z.device, rows)
        h = self.fc(z, dtype=dt).reshape(z.shape[0], -1, eh, ew)
        deconvs = [m for m in self.deconv
                   if isinstance(m, ConvTranspose2dTorch)]
        for i, m in enumerate(deconvs):
            h = m(h, dt, d2s=c.deconv_d2s)
            if i < len(deconvs) - 1:
                h = h.relu()
                if gen is not None:
                    h = _dropout(h, c.conv_dropout, gen)
        if c.decoder_sigmoid:
            h = torch.sigmoid(h)
        return h.permute(0, 2, 3, 1)


class Seq2SeqBinaryVAE(nn.Module):
    """CNN → LSTM → Binary-Concrete → LSTM → CNN sequence autoencoder.

    ``device``: where the parameters live; CUDA unless ``"cpu"`` is asked
    for (raises when there is no card). ``generator``: a CPU
    ``torch.Generator`` for the initial weights (torch's default
    distributions); seed 0 when omitted.
    """

    def __init__(self, cfg: RBVAEConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dt, L = cfg.torch_dtype, cfg.latent_dim
        self.encoder_cnn = ConvEncoder(cfg)
        self.decoder_cnn = ConvDecoder(cfg)
        self.encoder_rnn = LSTM(L, L, cfg.lstm_layers, cfg.lstm_residual, dt)
        self.decoder_rnn = LSTM(L, L, cfg.lstm_layers, cfg.lstm_residual, dt)
        self._init_weights(generator or torch.Generator().manual_seed(0))
        self.to(dev)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for convs and linears (torch's
        default, fan_in as torch computes it), U(-1/sqrt(H), 1/sqrt(H)) for
        the LSTMs' weights and ``bias_ih`` — drawn from ``gen``. ``bias_hh``
        starts at 0: ``svtpu`` has one bias a layer, U(-1/sqrt(H),
        1/sqrt(H)) (``svtpu/ops/lstm.py:51-61``), and the LSTM adds the two
        biases, so their sum has that law."""
        for m in self.modules():
            if isinstance(m, (Conv2dTorch, ConvTranspose2dTorch, Dense)):
                # weight[0] spans fan_in for all three layouts.
                bound = 1 / math.sqrt(m.weight[0].numel())
                bounds = {"weight": bound, "bias": bound}
            elif isinstance(m, nn.LSTM):
                bounds = {n: 1 / math.sqrt(m.hidden_size)
                          for n, _ in m.named_parameters()}
            else:
                continue
            for name, p in m.named_parameters(recurse=False):
                if name.startswith("bias_hh"):
                    p.zero_()
                    continue
                bound = bounds[name]
                p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound)
                        - bound)

    def _cnn(self, stack: nn.Module, *args):
        """Run a conv stack, through ``torch.utils.checkpoint`` when
        ``cfg.remat`` asks for it and a backward may follow."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(stack, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return stack(*args)

    def _encode_to_latent(self, x, temperature, hard, noise_scale,
                          generator, u, sampler: str = "torch",
                          trunk: str = "torch",
                          dropout_seed: DropoutSeed = None,
                          rows: Optional[draws.GlobalRows] = None):
        """Conv trunk + encoder LSTM + binarization.

        ``sampler``: "torch" (the plain op) or "kernel" (the sampler
        kernels; their noise is keyed by a seed drawn from ``generator``).
        On the kernel route a post-RNN variant whose LSTM the fused kernel
        takes (``lstm_cuda.takes``) runs the encoder LSTM and the sampler
        as one kernel, and its ``h_seq`` is ``None``; a wider one runs the
        plain LSTM, then the sampler kernel.
        ``trunk``: "torch", "kernel" (the fused conv0+conv1 kernel) or
        "int8" (``ConvEncoder.forward``).
        ``dropout_seed``: dropout in the conv trunk (training), or ``None``.
        ``rows``: a data-parallel rank's rows of the global batch, at which
        the noise and the dropout masks are drawn (``ops/draws.py``); the
        plain sampler only.
        """
        c = self.cfg
        if sampler not in ("torch", "kernel"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if sampler == "kernel" and rows is not None:
            raise ValueError("the sampler kernel draws its own noise; "
                             "global rows need sampler='torch'")
        generator = draws.sharded(generator, rows)
        if sampler == "kernel" and u is not None:
            raise ValueError("the sampler kernel draws its own noise; "
                             "an injected u needs sampler='torch'")
        noisy = generator is not None

        def seed(t):
            """A one-element int64 tensor on ``t``'s device, never read on
            the host: ``int()`` of a seed drawn on the card would wait for
            every launch before it. The copy onto a CPU ``t`` blocks: the
            plain sampler reads the seed there at once."""
            if not noisy:
                return 0
            return torch.randint(2 ** 31 - 1, (1,), generator=generator,
                                 device=generator.device).to(
                                     t.device,
                                     non_blocking=t.device.type == "cuda")

        def binarize(t):
            if sampler == "kernel":
                return binary_concrete_fused(t, seed(t), temperature,
                                             noise_scale, hard, c.bc_eps,
                                             noisy)
            return binary_concrete(t, generator, temperature, hard,
                                   c.bc_eps, noise_scale, u=u)

        B, T = x.shape[:2]
        flat = x.reshape((B * T,) + tuple(x.shape[2:]))
        logits = self._cnn(self.encoder_cnn, flat, trunk, dropout_seed,
                           rows).reshape(B, T, c.latent_dim)
        if c.binarize == "pre_rnn":
            # simple variant: binarize conv logits, then run the LSTMs.
            z_seq = binarize(logits)
            return logits, self.encoder_rnn(z_seq), z_seq
        if sampler == "kernel" and takes(self.encoder_rnn):
            return logits, None, lstm_binary_concrete(
                self.encoder_rnn, logits, seed(logits), temperature,
                noise_scale, hard, c.bc_eps, noisy)
        h_seq = self.encoder_rnn(logits)
        return logits, h_seq, binarize(h_seq)

    def _require_noise_source(self, deterministic, generator, u):
        if not deterministic and generator is None and u is None:
            raise ValueError("noise needs an explicit torch.Generator (or an "
                             "injected u); pass deterministic=True for none")

    def _require_dropout_seed(self, deterministic, dropout_seed):
        if (not deterministic and self.cfg.conv_dropout > 0
                and dropout_seed is None):
            raise ValueError("dropout needs a dropout_seed (an int); pass "
                             "deterministic=True for none")
        return None if deterministic else dropout_seed

    def forward(self, x: torch.Tensor, temperature=1.0, hard: bool = False,
                noise_ratio: float = 0.1, *, deterministic: bool = False,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None,
                dropout_seed: DropoutSeed = None,
                rows: Optional[draws.GlobalRows] = None) -> RBVAEOutput:
        """Full autoencoding pass, on the plain trunk and sampler.

        ``deterministic=False`` means dropout and noise, as in the
        reference: dropout masks come from ``dropout_seed`` (a host int or
        a train step's generators, ``DropoutSeed``; needed when the variant
        has dropout). Noise is drawn from
        ``generator`` or taken from ``u`` (uniform [0, 1), shaped like the
        binarized tensor) whenever either is given. ``rows``: ``x`` is a
        data-parallel rank's rows of a global batch, and both draws are
        taken at them (``ops/draws.py``).
        """
        c = self.cfg
        self._require_noise_source(deterministic, generator, u)
        dropout_seed = self._require_dropout_seed(deterministic, dropout_seed)
        B, T = x.shape[:2]
        noise_scale = noise_ratio if c.has_noise_ratio else 1.0
        logits, h_seq, z_seq = self._encode_to_latent(
            x, temperature, hard, noise_scale, generator, u,
            dropout_seed=dropout_seed, rows=rows)
        d_in = h_seq if c.binarize == "pre_rnn" else z_seq
        d_seq = self.decoder_rnn(d_in)
        x_recon = self._cnn(self.decoder_cnn,
                            d_seq.reshape(B * T, c.latent_dim), dropout_seed,
                            rows)
        x_recon = x_recon.reshape((B, T) + tuple(x_recon.shape[1:]))
        return RBVAEOutput(x_recon=x_recon, h_seq=h_seq, z_seq=z_seq,
                           logits=logits)

    def encode(self, x: torch.Tensor, temperature=0.5, hard: bool = False,
               noise_ratio: float = 0.1, *, deterministic: bool = True,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Binarized latents ``[B, T, L]`` only. Deterministic unless a
        ``generator`` (or ``u``) is given; ``cfg.pallas_trunk`` and
        ``cfg.pallas_sampler`` route through the hand-written kernels,
        ``cfg.int8_trunk`` (without ``pallas_trunk``) through the int8
        convs."""
        c = self.cfg
        self._require_noise_source(deterministic, generator, u)
        noise_scale = noise_ratio if c.has_noise_ratio else 1.0
        _, _, z_seq = self._encode_to_latent(
            x, temperature, hard, noise_scale, generator, u,
            sampler="kernel" if c.pallas_sampler else "torch",
            trunk=("kernel" if c.pallas_trunk
                   else "int8" if c.int8_trunk else "torch"))
        return z_seq
