"""Port vs JAX: the model-view renders of ops/image.py (the viewer's
model panes) on the same seeded maps."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kintinuous_tpu.ops.image import generate_depth as jax_depth
from kintinuous_tpu.ops.image import generate_image as jax_image
from kintinuous_tpu_torch.ops.image import generate_depth, generate_image

torch.set_num_threads(2)

H, W = 60, 80


def _maps(seed: int = 0):
    """Vertex and normal maps with a quarter of the pixels missing (NaN),
    colours 0..255 and weights 0..160 (past the heat ramp's 128)."""
    rng = np.random.default_rng(seed)
    vmap = rng.uniform(-1, 3, (3, H, W)).astype(np.float32)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    nmap = n / np.linalg.norm(n, axis=0, keepdims=True)
    miss = rng.random((H, W)) < 0.25
    vmap[:, miss] = np.nan
    nmap[:, miss] = np.nan
    color = rng.uniform(0, 255, (3, H, W)).astype(np.float32)
    weight = rng.uniform(0, 160, (H, W)).astype(np.float32)
    return vmap, nmap, color, weight


def _agree(a, b):
    """Equal on >= 99.9 % of pixels and never more than 1 apart."""
    a, b = np.asarray(a).astype(np.int32), b.numpy().astype(np.int32)
    assert a.shape == b.shape == (H, W, 3) and b.dtype == np.int32
    assert (a != b).any(axis=-1).mean() <= 1e-3, (a != b).any(axis=-1).sum()
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("mode", ["shaded", "color", "heat", "color_without_colour"])
def test_generate_image_matches_jax(mode):
    """Measured: equal on every pixel in each mode (a colour mode given
    no colour falls back to the shaded render in both)."""
    vmap, nmap, color, weight = _maps()
    m = "color" if mode == "color_without_colour" else mode
    c = None if mode == "color_without_colour" else color
    a = jax_image(jnp.asarray(vmap), jnp.asarray(nmap),
                  None if c is None else jnp.asarray(c), jnp.asarray(weight), mode=m)
    b = generate_image(torch.from_numpy(vmap), torch.from_numpy(nmap),
                       None if c is None else torch.from_numpy(c), torch.from_numpy(weight),
                       mode=m)
    assert b.dtype == torch.uint8
    _agree(a, b)
    if m != "color":  # a miss renders black (the colour mode keeps 0.3 of it)
        assert (b.numpy()[np.isnan(nmap[0])] == 0).all()


def test_generate_depth_matches_jax():
    """Depths from -1 to 8 m around the 6 m range, zeros included:
    measured equal on every pixel (astype truncates in both)."""
    rng = np.random.default_rng(1)
    depth = rng.uniform(-1.0, 8.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.2] = 0.0
    a = jax_depth(jnp.asarray(depth), 6.0)
    b = generate_depth(torch.from_numpy(depth), 6.0)
    assert b.dtype == torch.uint8
    _agree(a, b)
