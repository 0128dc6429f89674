"""Configurations — the port's own copy of ``svtpu.config``: ``VideoMeta``,
``parse_transition_flags`` and ``BUILTIN_VIDEOS`` (``svtpu/config.py:23-106``),
``RBVAEConfig`` and ``rbvae_variant`` (``:114-254``), ``TrainConfig``
(``:262-461``), ``PerceptualConfig`` (``:464-479``) and ``to_json`` /
``from_json`` (``:482-491``). ``VJEPA2Config`` and ``Sam2HieraConfig`` are
the port's own: the video encoder of the clip path and SAM 2.1's image
encoder, which ``svtpu`` does not have.

Field names and defaults are the reference's, so one config means the same
model in both packages. ``pallas_trunk`` / ``pallas_sampler`` keep their
names: here they route ``encode`` through the hand-written CUDA kernels
(``ops/conv_trunk_cuda.py``; ``ops/lstm_cuda.py`` after the encoder LSTM,
``ops/binarize_cuda.py`` before it).
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VideoMeta:
    """Per-video state-transition metadata: ``flags`` are the frame indices
    at which a state transition occurs, ``last_frame`` the final frame
    index (inclusive), ``grey_out`` the margin of frames dropped on both
    sides of every transition."""

    name: str
    flags: Tuple[int, ...]
    last_frame: int
    grey_out: int = 10

    @property
    def num_states(self) -> int:
        return len(self.flags) + 1

    def state_segments(self) -> Tuple[Tuple[int, int], ...]:
        """Half-open ``(start, end)`` per state, transition margins
        removed."""
        segs = []
        for i, flag in enumerate(self.flags):
            if i == 0:
                segs.append((0, flag - self.grey_out))
            else:
                segs.append((self.flags[i - 1] + self.grey_out + 1,
                             flag - self.grey_out))
        segs.append((self.flags[-1] + self.grey_out + 1, self.last_frame + 1))
        return tuple(segs)


def parse_transition_flags(path: str | Path) -> dict[str, VideoMeta]:
    """Parse a ``transition_flags.txt``-style metadata file::

        video_name:
        [f0, f1, ...], last_frame = N, grey_out = M
    """
    metas: dict[str, VideoMeta] = {}
    name = None
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        if line.endswith(":"):
            name = line[:-1].strip()
            continue
        m = re.match(
            r"\[(?P<flags>[\d,\s]*)\]\s*,\s*last_frame\s*=\s*(?P<last>\d+)"
            r"\s*,\s*grey_out\s*=\s*(?P<grey>\d+)", line)
        if m and name is not None:
            flags = tuple(
                int(x) for x in m.group("flags").split(",") if x.strip())
            metas[name] = VideoMeta(
                name=name, flags=flags, last_frame=int(m.group("last")),
                grey_out=int(m.group("grey")))
            name = None
    return metas


# The four videos the reference ships metadata for.
BUILTIN_VIDEOS = {
    "kid_playing_with_blocks": VideoMeta(
        "kid_playing_with_blocks",
        (152, 315, 486, 607, 734, 871, 1153, 1343), 1425, 10),
    "chinese_chess": VideoMeta(
        "chinese_chess", (74, 206, 282, 389), 479, 10),
    "assembly_C10118": VideoMeta(
        "assembly_C10118",
        (2836, 4132, 5114, 5640, 6922, 8390, 11518, 11962), 12297, 20),
    "ikea_asm_table": VideoMeta(
        "ikea_asm_table",
        (157, 205, 441, 494, 557, 887, 909, 1010, 1048, 1315, 1388, 1438,
         1702, 1847, 2096, 2174), 2469, 1),
}


@dataclasses.dataclass(frozen=True)
class RBVAEConfig:
    """One parameterized config covering the four reference variants
    (simple, contrastive, percep, triplet)."""

    variant: str = "contrastive"
    in_channels: int = 3
    out_channels: int = 3
    latent_dim: int = 32
    # Input spatial size (H, W): 256x256 pixels (contrastive/triplet),
    # 64x64 (simple), 88x160 SD latents (percep).
    input_hw: Tuple[int, int] = (256, 256)
    conv_features: Tuple[int, ...] = (64, 64, 64)
    conv_kernel: int = 3
    conv_stride: int = 2
    conv_padding: int = 1
    conv_dropout: float = 0.2
    # ReLU after the LAST encoder conv as well (the simple variant only).
    conv_final_relu: bool = False
    # LSTM depth; hidden size is wired to latent_dim as in every variant.
    lstm_layers: int = 2
    # Identity path around width-preserving LSTM layers.
    lstm_residual: bool = False
    # "pre_rnn" binarizes CNN logits before the LSTMs (simple); "post_rnn"
    # binarizes the encoder-LSTM output (the others).
    binarize: str = "post_rnn"
    bc_eps: float = 1e-8
    # Whether the noise_ratio multiplier exists (contrastive/percep).
    has_noise_ratio: bool = True
    decoder_sigmoid: bool = True
    # Compute dtype for conv/matmul; parameters are always float32.
    compute_dtype: str = "float32"
    # Recompute the conv encoder's and decoder's activations in the backward
    # pass (torch.utils.checkpoint) instead of keeping them.
    remat: bool = False
    # Inference ``encode`` through the hand-written sampler kernels (fused
    # with the encoder LSTM where the variant binarizes after it).
    pallas_sampler: bool = False
    # Inference ``encode`` through the hand-written conv0+conv1 kernel
    # (contrastive/triplet 256x256 pixel geometry only).
    pallas_trunk: bool = False
    # Accepted and ignored: the Hopper kernel picks its own tiles.
    pallas_trunk_block: int = 1
    # Inference ``encode`` with every encoder conv but conv0 in dynamic
    # symmetric int8 (``ops/conv.py::conv2d_int8``); ``pallas_trunk`` wins
    # over it. Its codes can differ from the compute dtype's: measure the
    # code-match rate per checkpoint before relying on it.
    int8_trunk: bool = False
    # conv0 (k3/s2/p1, even H and W) as a k2/s1 conv over 2x2
    # space-to-depth blocks: the same parameters and result.
    conv0_s2d: bool = False
    # Each k3/s2/p1/op1 decoder stage as a k2/s1 conv to four phases and a
    # depth-to-space: the same parameters and result.
    deconv_d2s: bool = False

    @property
    def encoded_hw(self) -> Tuple[int, int]:
        h, w = self.input_hw
        for _ in self.conv_features:
            h = (h + 2 * self.conv_padding - self.conv_kernel) // self.conv_stride + 1
            w = (w + 2 * self.conv_padding - self.conv_kernel) // self.conv_stride + 1
        return (h, w)

    @property
    def encoded_dim(self) -> int:
        h, w = self.encoded_hw
        return self.conv_features[-1] * h * w

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def rbvae_variant(name: str, latent_dim: int = 32, *,
                  compute_dtype: str = "float32", **overrides) -> RBVAEConfig:
    """Factory for the four reference variants by name (and the sweep
    aliases ``contrastive_z``/``contrastive_p``/``percep_p``)."""
    name = {"contrastive_z": "contrastive",
            "contrastive_p": "contrastive",
            "percep_p": "percep"}.get(name, name)
    base = dict(latent_dim=latent_dim, compute_dtype=compute_dtype)
    if name == "simple":
        cfg = dict(
            variant="simple", input_hw=(64, 64), conv_features=(64, 128, 256),
            conv_kernel=4, conv_dropout=0.0, conv_final_relu=True,
            lstm_layers=1, binarize="pre_rnn", bc_eps=1e-10,
            has_noise_ratio=False)
    elif name == "contrastive":
        cfg = dict(variant="contrastive")
    elif name == "triplet":
        cfg = dict(variant="triplet", has_noise_ratio=False)
    elif name == "percep":
        cfg = dict(
            variant="percep", in_channels=4, out_channels=4,
            input_hw=(88, 160), conv_features=(256, 256, 256), lstm_layers=4)
    else:
        raise ValueError(f"unknown RBVAE variant: {name!r}")
    cfg.update(base)
    cfg.update(overrides)
    return RBVAEConfig(**cfg)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer hyperparameters; the fields and defaults of
    ``svtpu.config.TrainConfig``, whose comments give each one's reason."""

    batch_size: int = 32
    num_epochs: int = 50
    learning_rate: float = 1e-3
    init_temperature: float = 1.0
    final_temperature: float = 0.5
    anneal_rate: float = 1e-3
    num_steps_to_update: int = 100
    bernoulli_p: float = 0.1
    noise_ratio: float = 0.1
    # Noise ratio of the metric/selection encodes; None = noise_ratio.
    eval_noise_ratio: Optional[float] = None
    margin: float = 0.2
    alpha: float = 1.0           # contrastive or triplet coefficient
    beta_kl: float = 1.0
    test_pct: float = 0.1
    val_pct: float = 0.1
    seed: int = 0
    # "contrastive" | "triplet" | "simple".
    objective: str = "contrastive"
    # Triplet distance: "l2" or "js" (Bernoulli JS on z probabilities).
    triplet_distance: str = "l2"
    # Weight of the anchor<->positive pull in p-space (triplet); 0 = off.
    triplet_pull: float = 0.0
    # Weight of the absolute (anchor, negative) push in p-space; 0 = off.
    triplet_push: float = 0.0
    # What the contrastive/triplet losses act on: "h", "z" or "p".
    contrast_on: str = "h"
    # Also apply the margins to context-free (T=1) encodes of the frames.
    contextfree_contrast: bool = False
    # "consistency" | "val_loss" | "separation" | "combined".
    select_by: str = "consistency"
    # Separation (bits) at which "combined" stops rewarding separation.
    sep_target: float = 3.0
    # Reduction of the adjacent-pair Hamming vector: "mean" or "min".
    sep_aggregate: str = "mean"
    log_dir: Optional[str] = None
    # Device layout (``parallel.mesh.make_mesh``): "data" splits each batch
    # over its ranks, "model" shards the big projections; without a process
    # group the mesh is one rank.
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    # Keep the whole store on the device and feed steps row indices:
    # "auto" (when it is <= 2 GiB), True, False.
    stage_frames: object = "auto"
    # Run a staged epoch with its metric sums on the device and one
    # readback (the per-step loop reads every step's metrics back).
    fused_epoch: bool = True
    # "linear" scales lr with a batch rounded up to the data axis.
    lr_scaling: str = "linear"
    # Save ``latest`` every N epochs; 0 disables.
    latest_every: int = 25
    # Run the validation block every N epochs (final and restart-check
    # epochs always).
    val_every: int = 1
    # Auto-restart on basin failure; 0 disables.
    restart_check_epoch: int = 0
    restart_min_sep: float = 3.0
    max_restarts: int = 3
    # Reduction the basin check compares: "mean" or "min".
    restart_on: str = "mean"
    # What a restart re-rolls: "init" or "stream" (also pairs and noise).
    restart_reroll: str = "init"
    # Keep the context-free |h|/T ratio at or below this band by raising
    # the temperature floor; 0 disables.
    trap_guard_ratio: float = 0.0
    # L1 coefficient on the binarization logits h; 0 disables.
    l1_logits: float = 0.0


@dataclasses.dataclass(frozen=True)
class PerceptualConfig:
    """SD AutoencoderKL first-stage config (v1-inference.yaml:46-67)."""

    embed_dim: int = 4
    z_channels: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    scale_factor: float = 0.18215
    # Preprocessing: resize target before %32 snap
    # (``get_percep_embeddings.py:59-66``) — 1280x720 → 1280x704.
    resize_wh: Tuple[int, int] = (1280, 720)
    compute_dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class VJEPA2Config:
    """V-JEPA 2's video encoder, ViT-L/16 over 64-frame clips at 256x256:
    the widths of ``facebook/vjepa2-vitl-fpc64-256``'s config.json, and
    its preprocessing (``video_processing_vjepa2.py``: the shorter side
    resized to ``int(crop_size * 256 / 224)``, the centre
    ``crop_size`` square, ImageNet's mean and deviation). The predictor
    and the attentive pooler are not on the encode path."""

    crop_size: int = 256
    frames_per_clip: int = 64
    patch_size: int = 16
    tubelet_size: int = 2
    in_chans: int = 3
    hidden_size: int = 1024
    num_attention_heads: int = 16
    num_hidden_layers: int = 24
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    image_mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    compute_dtype: str = "bfloat16"

    @property
    def resize_short(self) -> int:
        return int(self.crop_size * 256 / 224)

    @property
    def grid(self) -> Tuple[int, int, int]:
        """Tokens along (time, rows, columns) of one clip."""
        s = self.crop_size // self.patch_size
        return (self.frames_per_clip // self.tubelet_size, s, s)

    @property
    def num_tokens(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class Sam2HieraConfig:
    """SAM 2.1's image encoder, Hiera-L with its FPN neck: the widths of
    ``facebook/sam2.1-hiera-large`` (``sam2/configs/sam2.1/
    sam2.1_hiera_l.yaml``; transformers' ``Sam2HieraDetConfig`` and
    ``Sam2VisionConfig`` field names), and its preprocessing
    (``image_processing_sam2_fast.py``: bilinear, antialiased resize to
    ``image_size`` square, the aspect ratio not kept, divided by 255,
    ImageNet's mean and deviation). Block ``i``'s window is its stage's
    (the previous stage's at a stage's first block), 0 (global) at
    ``global_attention_blocks``; the first block of stages 2 to
    ``num_query_pool_stages + 1`` max-pools its queries by
    ``query_stride``. The prompt encoder, the mask decoder and the memory
    path are not on the encode path."""

    image_size: int = 1024
    num_channels: int = 3
    patch_kernel_size: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    blocks_per_stage: Tuple[int, ...] = (2, 6, 36, 4)
    embed_dim_per_stage: Tuple[int, ...] = (144, 288, 576, 1152)
    num_attention_heads_per_stage: Tuple[int, ...] = (2, 4, 8, 16)
    window_size_per_stage: Tuple[int, ...] = (8, 4, 16, 8)
    global_attention_blocks: Tuple[int, ...] = (23, 33, 43)
    query_stride: int = 2
    num_query_pool_stages: int = 3
    window_positional_embedding_background_size: Tuple[int, ...] = (7, 7)
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    fpn_hidden_size: int = 256
    backbone_channel_list: Tuple[int, ...] = (1152, 576, 288, 144)
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    image_mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    compute_dtype: str = "bfloat16"

    @property
    def grid(self) -> int:
        """Tokens along a side of the patch embed's grid (256)."""
        return self.image_size // self.patch_stride

    @property
    def blocks(self) -> list:
        """Each block's ``(stage, dim_in, dim_out, heads, window,
        pooled)``."""
        out = []
        for st, n in enumerate(self.blocks_per_stage):
            for j in range(n):
                first = st > 0 and j == 0
                prev = st - 1 if first else st
                window = 0 if len(out) in self.global_attention_blocks \
                    else self.window_size_per_stage[prev]
                out.append((st, self.embed_dim_per_stage[prev],
                            self.embed_dim_per_stage[st],
                            self.num_attention_heads_per_stage[st], window,
                            first and st <= self.num_query_pool_stages))
        return out

    @property
    def feature_hw(self) -> int:
        """A side of the output level: stage 3's grid (64)."""
        return self.grid // self.query_stride ** 2

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def to_json(cfg) -> str:
    """A config as JSON, the same text ``svtpu``'s ``to_json`` gives for the
    same field values."""
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_json(cls, s: str):
    """Inverse of :func:`to_json` for the dataclass ``cls`` (JSON lists
    become the tuples the fields hold)."""
    d = json.loads(s)
    for f in dataclasses.fields(cls):
        if f.name in d and isinstance(d[f.name], list):
            d[f.name] = tuple(d[f.name])
    return cls(**d)
