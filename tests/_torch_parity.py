"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy
arrays go to the JAX package (on the CPU, Pallas in interpret mode) and to
the PyTorch port, and results come back as numpy for comparison.

JAX is imported only where a test needs it, so the kernel-vs-plain tests
also run on a machine with a card and no JAX:
``python -m pytest --noconftest tests/test_torch_*.py -k on_card``."""

import importlib

import numpy as np
import pytest
import torch

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def randn(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def jax_modules(*names):
    """Import modules of JAX or the JAX package; skip where JAX is absent."""
    pytest.importorskip("jax")
    return [importlib.import_module(n) for n in names]


def to_jax(x, dtype="float32"):
    if x is None:
        return None
    import jax.numpy as jnp

    return jnp.asarray(x, getattr(jnp, dtype))


def to_torch(x, dtype="float32", device="cpu"):
    if x is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=TORCH_DTYPES[dtype])


def np32(x):
    """float32 numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, the JAX suite's relative measure."""
    g, w = np32(got), np32(want)
    return float(np.max(np.abs(g - w)) / (np.max(np.abs(w)) + 1e-12))


def row_rel_err(got, want) -> float:
    """The largest, over rows (the last dim), of a row's max |got - want|
    over that row's max |want|: kernel-vs-plain on the card, where late
    causal rows are far smaller than row 0 and a whole-tensor measure would
    let an error in them pass. A row that is 0 in ``want`` must be 0 in
    ``got`` too."""
    g, w = np32(got), np32(want)
    err, ref = np.abs(g - w).max(-1), np.abs(w).max(-1)
    return float(np.max(np.where(err == 0, 0.0, err / np.maximum(ref, 1e-30))))


def grad_row_rel_err(got, want, floor: float = 1e-3) -> float:
    """``row_rel_err`` for gradients: each row's error over the larger of
    its own max |want| and ``floor`` times the tensor's. A gradient row can
    be zero by cancellation (causal row 0 sees one key, so dP equals delta
    and dS is 0 up to fp32 rounding on both sides); without the floor its
    rounding noise would be divided by ~0."""
    g, w = np32(got), np32(want)
    err, ref = np.abs(g - w).max(-1), np.abs(w).max(-1)
    ref = np.maximum(ref, floor * np.abs(w).max())
    return float(np.max(np.where(err == 0, 0.0, err / np.maximum(ref, 1e-30))))


@pytest.fixture
def cuda():
    """The CUDA device for kernel-vs-plain tests; skips on a machine with
    no card (decided when the test runs, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")
