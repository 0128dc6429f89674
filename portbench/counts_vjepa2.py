"""Operations of V-JEPA 2's encoder on one clip, counted from its shapes
(``configs/vjepa2-vitl-fpc64-256.json``), as ``counts.py`` counts the
other cells' work: a multiply-add counts two operations. Frozen here so
that a change to the program cannot move its own yardstick."""
from __future__ import annotations


def tokens(cfg: dict) -> int:
    g = cfg["crop_size"] // cfg["patch_size"]
    return cfg["frames_per_clip"] // cfg["tubelet_size"] * g * g


def clip_macs(cfg: dict) -> dict:
    """Multiply-adds of one clip by part: the tubelet embed; over all
    layers, q, k, v and the output projection, the MLP, and attention's two
    products (``2 N^2 hidden`` a layer); norms, GELU and the rotary
    embedding are not counted."""
    N, C = tokens(cfg), cfg["hidden_size"]
    M = int(C * cfg["mlp_ratio"])
    L = cfg["num_hidden_layers"]
    patch = cfg["in_chans"] * cfg["tubelet_size"] * cfg["patch_size"] ** 2
    return {"embed": N * patch * C, "qkvo": L * 4 * N * C * C,
            "mlp": L * 2 * N * C * M, "attention": L * 2 * N * N * C}


def clip_flops(cfg: dict) -> float:
    """Operations of one clip's encode."""
    return 2.0 * sum(clip_macs(cfg).values())
