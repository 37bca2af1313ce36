"""Port vs JAX: the cost-model probes P1-P4 (tools/proto_integrate_pallas.py,
ported as kintinuous_tpu_torch/tools/proto_integrate.py). The JAX tool
runs in the TPU interpret mode at K=64 rows of a (264,4,128) volume; the
port's plain versions must give its output bit for bit. P4's run_dyn is
local to the tool's main, so it is held against run_rows over the first
n ids, which is what it computes."""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kintinuous_tpu_torch.tools import proto_integrate as P
from tests.test_torch_package import ROOT

torch.set_num_threads(2)

K_SMALL, ROWS_SMALL, N_SMALL = 64, 264, 37


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "proto_integrate_pallas", ROOT / "tools" / "proto_integrate_pallas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jx(t):
    """A port tensor as a JAX array of the same type (bf16 included)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("probe", ["rows", "dma", "full", "dyn"])
def test_probe_plain_matches_the_tpu_tool(tool, monkeypatch, probe):
    x = P.make_inputs("cpu", n_rows=ROWS_SMALL, k=K_SMALL)
    monkeypatch.setattr(tool, "N_ROWS", ROWS_SMALL)
    monkeypatch.setattr(tool, "K", N_SMALL if probe == "dyn" else K_SMALL)
    corners = (x.cy, x.cx)
    got = x.tsdf.clone()
    with pltpu.force_tpu_interpret_mode():
        if probe == "rows":
            want = tool.run_rows(jx(x.tsdf), jx(x.ids))
            P.run_rows(got, x.ids)
        elif probe == "dyn":
            want = tool.run_rows(jx(x.tsdf), jx(x.ids[:N_SMALL]))
            P.run_dyn(torch.tensor(N_SMALL, dtype=torch.int32), got, x.ids)
        else:
            fn = {"dma": tool.run_dma, "full": tool.run_full}[probe]
            want = fn(jx(x.tsdf), jx(x.ids), (jx(x.cy), jx(x.cx)), jx(x.img), jx(x.img2))
            getattr(P, f"run_{probe}")(got, x.ids, corners, x.img, x.img2)
    assert np.array_equal(bits(got.numpy()), bits(want))
    changed = int((got != x.tsdf).any(dim=(1, 2)).sum())
    assert changed == (N_SMALL if probe == "dyn" else K_SMALL)


def test_probe_inputs_follow_the_tool():
    """The ids and corners come from the TPU tool's own RandomState seeds
    at its full shapes: unique rows, corners on its 16-row and 128-column
    grid, inside the images."""
    x = P.make_inputs("cpu")
    ids = x.ids.numpy()
    assert ids.shape == (P.N_K,) and len(np.unique(ids)) == P.N_K
    assert ids.max() < P.N_ROWS - 1
    cy, cx = x.cy.numpy(), x.cx.numpy()
    assert (cy % 16 == 0).all() and cy.max() + P.PH <= P.H
    assert set(np.unique(cx)) <= {0, 128, 256, 384}
    assert x.img.shape == (2, P.H, P.W) and x.img2.shape == (3, P.H2, P.W2)
    want = np.random.RandomState(0).choice(P.N_ROWS - 1, P.N_K, False)
    assert np.array_equal(ids, want)


def test_probe_tool_runs_on_the_cpu(capsys):
    """The tool's entry point with --device cpu: four timed lines; the
    kernels are not launched for CPU tensors."""
    before = [w.launches for w in (P.run_rows, P.run_dma, P.run_full, P.run_dyn)]
    assert P.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and all(ln.endswith("ms  (cpu)") for ln in lines)
    assert [w.launches for w in (P.run_rows, P.run_dma, P.run_full, P.run_dyn)] == before


@pytest.mark.parametrize("n", [0, K_SMALL + 5], ids=["n0", "n_past_k"])
def test_run_dyn_walks_its_count_clamped_to_the_ids(tool, monkeypatch, n):
    """P4 with n = 0 and with n past the k ids: the TPU tool's run_rows
    over the first min(n, k) ids, bit for bit. A grid of 0 steps is the
    identity (the interpreter cannot run one: it reads the first id),
    so n = 0 must leave the volume as it was."""
    x = P.make_inputs("cpu", n_rows=ROWS_SMALL, k=K_SMALL)
    m = min(n, K_SMALL)
    monkeypatch.setattr(tool, "N_ROWS", ROWS_SMALL)
    monkeypatch.setattr(tool, "K", m)
    got = x.tsdf.clone()
    P.run_dyn(torch.tensor(n, dtype=torch.int32), got, x.ids)
    want = x.tsdf.numpy()
    if m:
        with pltpu.force_tpu_interpret_mode():
            want = tool.run_rows(jx(x.tsdf), jx(x.ids[:m]))
    assert np.array_equal(bits(got.numpy()), bits(want))
    assert int((got != x.tsdf).any(dim=(1, 2)).sum()) == m
