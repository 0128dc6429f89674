"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""
import functools

import numpy as np

import jax
import jax.numpy as jnp

from svtpu.models.rbvae import Seq2SeqBinaryVAE as JaxRBVAE


def seeded_jax_params(jcfg, seed: int = 0):
    """``svtpu`` RBVAE params drawn from a numpy seed: U(±1/sqrt(fan_in))
    weights and U(±0.1) biases in the tree ``init`` would build. Only the
    tree's shapes are traced; nothing is compiled."""
    x0 = jnp.zeros((1, 1) + tuple(jcfg.input_hw) + (jcfg.in_channels,),
                   jnp.float32)
    shapes = jax.eval_shape(lambda k: JaxRBVAE(jcfg).init(
        {"params": k}, x0, 1.0, False, deterministic=True),
        jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(leaf):
        b = 1 / np.sqrt(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 0.1
        return rng.uniform(-b, b, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def seeded_ae_params(jcfg, seed: int = 0):
    """``svtpu`` AutoencoderKL params drawn from a numpy seed: conv kernels
    U(±1/sqrt(fan_in)), biases U(±0.1), GroupNorm scales 1 + U(±0.1), in
    the tree ``init`` would build. Only the tree's shapes are traced."""
    from svtpu.models.autoencoder_kl import AutoencoderKL

    x0 = jnp.zeros((1, 16, 16, jcfg.in_channels), jnp.float32)
    shapes = jax.eval_shape(lambda k: AutoencoderKL(jcfg).init(
        {"params": k}, x0), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            b = 1 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.uniform(-b, b, leaf.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.uniform(-0.1, 0.1, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class ArrayStore:
    """An in-memory frame store with ``FrameStore``'s interface (``array``,
    ``indices``, ``rows``, ``gather``, ``item_shape``, ``dtype``): row ``i``
    holds frame id ``indices[i]``."""

    def __init__(self, array, indices=None):
        self.array = array
        self.indices = np.arange(len(array)) if indices is None \
            else np.asarray(indices)
        self._row = {int(f): r for r, f in enumerate(self.indices)}

    @property
    def item_shape(self):
        return self.array.shape[1:]

    @property
    def dtype(self):
        return self.array.dtype

    def rows(self, frame_indices):
        flat = np.asarray(frame_indices).reshape(-1)
        return np.asarray([self._row[int(i)] for i in flat],
                          np.int64).reshape(np.shape(frame_indices))

    def gather(self, frame_indices):
        return self.array[self.rows(frame_indices)]


@functools.lru_cache(maxsize=None)
def eval_model():
    """The evaluation tests' tiny model (``tests/test_evaluation.py:22-29``):
    ``(svtpu config, svtpu params, port config, port state dict)``, the
    params drawn by ``svtpu``'s own init at key 0 and carried across by
    ``from_jax_params``."""
    from svtpu.config import rbvae_variant as jax_variant
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.models.convert import from_jax_params

    jcfg = jax_variant("contrastive", latent_dim=6, input_hw=(32, 32))
    tcfg = rbvae_variant("contrastive", latent_dim=6, input_hw=(32, 32))
    x0 = jnp.zeros((1, 1, 32, 32, 3))
    params = JaxRBVAE(jcfg).init({"params": jax.random.key(0)}, x0, 1.0,
                                 False, deterministic=True)
    return jcfg, params, tcfg, from_jax_params(params, tcfg)


def eval_frames() -> np.ndarray:
    """``tests/test_evaluation.py:32-38``'s 30 seeded frames: three states
    of ten, one bright channel each, plus noise."""
    rng = np.random.default_rng(0)
    f = np.zeros((30, 32, 32, 3), np.float32)
    for i in range(30):
        f[i, ..., i // 10] = 0.8
    return np.clip(f + rng.normal(0, 0.05, f.shape), 0, 1).astype(np.float32)
