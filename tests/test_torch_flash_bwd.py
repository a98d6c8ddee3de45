"""The port's backward launchers against the JAX package's.

``_dkdv_launch`` (both ``emit_ds`` settings), ``_dq_launch`` (with dbias)
and ``_banded_dq_from_ds`` take the same numpy inputs on both sides: JAX
runs its Pallas kernels in interpret mode, the port (on the CPU) their
plain versions. Both get the JAX forward's (o, lse), so the comparison is
the backward's arithmetic alone.

Tolerances: the JAX suite's gradient contract (tests/test_ffpa_bwd.py:19),
bf16 5e-2 and fp16 1e-2 relative to max|want|; the dropout keep masks of
the two packages are compared bit for bit. On the card each kernel is held
to its plain version per row (``grad_row_rel_err``) at the same tolerances.
"""

import functools
import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, grad_row_rel_err, jax_modules, randn, rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import flash_bwd as tbwd
from ffpa_attn_tpu_torch.ops import rng as trng
from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config

TOL = {"bfloat16": 5e-2, "float16": 1e-2}

CASES = {
    "causal": dict(nq=130, nkv=150, causal=True),
    "noncausal": dict(nq=100, nkv=160),
    "bias_full": dict(nq=120, nkv=150, bias="full"),
    "bias_key_causal": dict(nq=130, nkv=150, causal=True, bias="key"),
    "softcap": dict(nq=130, nkv=150, causal=True, softcap=5.0),
    "window": dict(nq=160, nkv=160, window=(40, 8)),
    "alibi": dict(nq=130, nkv=150, causal=True, alibi=True),
    "dropout": dict(nq=130, nkv=150, causal=True, dropout=0.2),
    "batch2_gqa_bias": dict(b=2, hq=4, hkv=2, nq=110, nkv=140, causal=True, bias="full"),
    "fp16": dict(nq=130, nkv=150, causal=True, dtype="float16"),
    # D != Dv: the wgmma dK/dV and dQ routes stream different box counts.
    "d320_dv512_causal_bias": dict(nq=130, nkv=150, causal=True, bias="full", d=320, dv=512),
    "d512_dv320_window": dict(nq=160, nkv=160, window=(40, 8), d=512, dv=320),
    # D or Dv above 512: the dK/dV cluster of two blocks, each rank holding
    # half of D's and of Dv's boxes (at D64 / Dv1024 rank 1 holds no D box).
    "d1024_causal_fp16": dict(nq=130, nkv=150, causal=True, dtype="float16", d=1024),
    "d640_bias_full": dict(nq=120, nkv=150, bias="full", d=640),
    "d512_dv1024_dropout": dict(nq=130, nkv=150, causal=True, dropout=0.2, d=512, dv=1024),
    "d1024_dv320_window": dict(nq=160, nkv=160, window=(40, 8), d=1024, dv=320),
    "d64_dv1024_causal": dict(nq=130, nkv=150, causal=True, d=64, dv=1024),
    # The recompute dQ's cluster: an odd box count (rank 0 five D boxes,
    # rank 1 four) with dropout, and softcap with a key bias at D1024.
    "d576_causal_dropout": dict(nq=130, nkv=150, causal=True, dropout=0.2, d=576),
    "d1024_softcap_keybias": dict(nq=130, nkv=150, causal=True, softcap=5.0, bias="key",
                                  d=1024),
}
CAUSAL = sorted(n for n, c in CASES.items() if c.get("causal"))


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    b, hq, hkv = case.get("b", 1), case.get("hq", 2), case.get("hkv", 1)
    nq, nkv, d = case["nq"], case["nkv"], case.get("d", 320)
    dv = case.get("dv", d)
    x = dict(q=randn(rng, (b, hq, nq, d)), k=randn(rng, (b, hkv, nkv, d)),
             v=randn(rng, (b, hkv, nkv, dv)), do=randn(rng, (b, hq, nq, dv)),
             bias=None, alibi=None)
    if case.get("bias") == "full":
        x["bias"] = randn(rng, (b, 1, nq, nkv))
    elif case.get("bias") == "key":
        x["bias"] = randn(rng, (1, 1, 1, nkv))
    if case.get("alibi"):
        x["alibi"] = rng.uniform(0.01, 0.3, (b, hq)).astype(np.float32)
    return x


def _static(case, x):
    d, nq, nkv = x["q"].shape[-1], x["q"].shape[2], x["k"].shape[2]
    return dict(
        scale=1.0 / math.sqrt(d), is_causal=case.get("causal", False),
        causal_offset=nkv - nq, dropout_p=case.get("dropout", 0.0),
        group=x["q"].shape[1] // x["k"].shape[1], softcap=case.get("softcap", 0.0),
        window=case.get("window", (-1, -1)),
    )


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """The JAX forward's (o, lse), delta, and the JAX launchers' outputs,
    as numpy."""
    import jax.numpy as jnp
    from ffpa_attn_tpu.ops import flash_bwd as jbwd
    from ffpa_attn_tpu.ops import flash_fwd as jfwd
    from ffpa_attn_tpu.ops.config import BlockConfig

    case = CASES[name]
    dt = case.get("dtype", "bfloat16")
    x = _inputs(case)
    st = _static(case, x)
    q, k, v, do = (to_jax(x[n], dt) for n in ("q", "k", "v", "do"))
    bias, alibi = to_jax(x["bias"]), to_jax(x["alibi"])
    o, lse = jfwd.flash_attention_forward(
        q, k, v, bias, scale=st["scale"], is_causal=st["is_causal"],
        dropout_p=st["dropout_p"], dropout_seed=3, softcap=st["softcap"],
        window=st["window"], alibi_slopes=alibi,
    )
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    nq, nkv = x["q"].shape[2], x["k"].shape[2]
    cfg = BlockConfig().clamp(nq, nkv)
    seed = jnp.asarray(3, jnp.int32).reshape(1, 1)
    kw = dict(st, interpret=True, alibi=alibi)
    dk, dv, ds = jbwd._dkdv_launch(q, k, v, bias, do, lse, delta, seed, cfg,
                                   grad_kv_storage_dtype=None, emit_ds=True, **kw)
    dq, dbias = jbwd._dq_launch(q, k, v, bias, do, lse, delta, seed, cfg,
                                grad_q_storage_dtype=None, **kw)
    out = dict(lse=lse, delta=delta, dk=dk, dv=dv, ds=ds, dq=dq, dbias=dbias)
    if st["is_causal"]:
        out["banded_dq"] = jbwd._banded_dq_from_ds(
            ds, k, cfg, scale=st["scale"], group=st["group"], nq=nq, nkv=nkv,
            causal_offset=st["causal_offset"], dq_dtype=q.dtype, interpret=True,
        )
    return x, {n: (None if a is None else np.array(a, np.float32)) for n, a in out.items()}


@pytest.fixture(scope="module")
def jax_ready():
    jax_modules("jax", "ffpa_attn_tpu.ops.flash_bwd")


def _port_args(case, x, j, dtype, device="cpu"):
    t = {n: to_torch(x[n], dtype, device) for n in ("q", "k", "v", "do")}
    return (t["q"], t["k"], t["v"], to_torch(x["bias"], device=device), t["do"],
            to_torch(j["lse"], device=device), to_torch(j["delta"], device=device))


def _config(x, dtype):
    d, dv, nq, nkv = x["q"].shape[-1], x["v"].shape[-1], x["q"].shape[2], x["k"].shape[2]
    return pick_backward_config(d=d, dv=dv, nq=nq, nkv=nkv, dtype=getattr(torch, dtype))


def _dkdv(case, x, j, emit, device="cpu"):
    dt = case.get("dtype", "bfloat16")
    st = _static(case, x)
    return tbwd._dkdv_launch(
        *_port_args(case, x, j, dt, device), 3, _config(x, dt),
        grad_kv_storage_dtype=None, emit_ds=emit, alibi=to_torch(x["alibi"], device=device), **st,
    )


def _dq(case, x, j, device="cpu"):
    dt = case.get("dtype", "bfloat16")
    return tbwd._dq_launch(
        *_port_args(case, x, j, dt, device), 3, _config(x, dt),
        grad_q_storage_dtype=None, alibi=to_torch(x["alibi"], device=device),
        **_static(case, x),
    )


@pytest.mark.parametrize("emit_ds", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dkdv_matches_jax(jax_ready, name, emit_ds):
    case = CASES[name]
    x, j = _jax_side(name)
    tol = TOL[case.get("dtype", "bfloat16")]
    dk, dv, ds = _dkdv(case, x, j, emit_ds)
    assert dk.dtype == dv.dtype == to_torch(x["q"], case.get("dtype", "bfloat16")).dtype
    assert rel_err(dk, j["dk"]) < tol, "dk"
    assert rel_err(dv, j["dv"]) < tol, "dv"
    if not emit_ds:
        assert ds is None
        return
    nq, nkv = x["q"].shape[2], x["k"].shape[2]
    assert ds.shape[2] % 64 == 0 and ds.shape[3] % 32 == 0
    assert rel_err(ds[:, :, :nq, :nkv], j["ds"][:, :, :nq, :nkv]) < tol, "ds"
    # Padding holds zeros: the banded dQ and dbias read the whole slab.
    assert not ds[:, :, nq:].any() and not ds[:, :, :, nkv:].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_dq_matches_jax(jax_ready, name):
    case = CASES[name]
    x, j = _jax_side(name)
    tol = TOL[case.get("dtype", "bfloat16")]
    dq, dbias = _dq(case, x, j)
    assert rel_err(dq, j["dq"]) < tol, "dq"
    if x["bias"] is None:
        assert dbias is None
    else:
        assert tuple(dbias.shape) == x["bias"].shape
        assert rel_err(dbias, j["dbias"]) < tol, "dbias"


@pytest.mark.parametrize("name", CAUSAL)
def test_banded_dq_matches_jax(jax_ready, name):
    case = CASES[name]
    x, j = _jax_side(name)
    dt = case.get("dtype", "bfloat16")
    st = _static(case, x)
    nq, nkv = x["q"].shape[2], x["k"].shape[2]
    # Both sides read the JAX slab, so only the product is compared.
    dq = tbwd._banded_dq_from_ds(
        to_torch(j["ds"], dt), to_torch(x["k"], dt), _config(x, dt), scale=st["scale"],
        group=st["group"], nq=nq, nkv=nkv, causal_offset=st["causal_offset"],
        dq_dtype=getattr(torch, dt),
    )
    assert rel_err(dq, j["banded_dq"]) < TOL[dt]


def test_dropout_keep_mask_is_the_jax_one(jax_ready):
    """The hash is shared: the keep masks agree bit for bit, at global ids
    shifted as a striped launch shifts them."""
    import jax.numpy as jnp
    from ffpa_attn_tpu.ops import rng as jrng

    rows, cols = trng.make_row_col_ids(96, 80, row_offset=128, col_offset=384)
    want = np.asarray(jrng.dropout_keep_mask(
        jnp.int32(3), 1, 5, jnp.asarray(rows.numpy(), jnp.int32),
        jnp.asarray(cols.numpy(), jnp.int32), 0.2))
    got = trng.dropout_keep_mask(3, 1, 5, rows, cols, 0.2).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < 1 - got.mean() < 0.3


def test_striped_handoff_matches_jax(jax_ready, monkeypatch):
    """A slab limit of a third of the dS slab cuts it into three KV
    stripes; under causal the later stripes drop the Q rows that cannot see
    them, and dropout replays on global ids."""
    import jax.numpy as jnp
    from ffpa_attn_tpu.ops import flash_bwd as jbwd
    from ffpa_attn_tpu.ops import flash_fwd as jfwd

    b, hq, n, d = 1, 2, 384, 320
    monkeypatch.setenv("FFPA_TORCH_DS_HANDOFF_LIMIT_BYTES", str(b * hq * n * n * 2 // 3))
    rng = np.random.default_rng(4)
    x = {name: randn(rng, (b, hq, n, d)) for name in ("q", "k", "v", "do")}
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=True, dropout_p=0.1, dropout_seed=3)
    jq, jk, jv, jdo = (to_jax(x[name], "bfloat16") for name in ("q", "k", "v", "do"))
    o, lse = jfwd.flash_attention_forward(jq, jk, jv, None, **kw)
    want = jbwd.flash_attention_backward(jq, jk, jv, None, o, lse, jdo, ds_handoff=False, **kw)
    tq, tk, tv, tdo = (to_torch(x[name], "bfloat16") for name in ("q", "k", "v", "do"))
    launches = tbwd._banded_dq_from_ds.launches
    got = tbwd.flash_attention_backward(
        tq, tk, tv, None, to_torch(np.asarray(o, np.float32), "bfloat16"),
        to_torch(np.asarray(lse)), tdo, ds_handoff=True, **kw,
    )
    assert tbwd._banded_dq_from_ds.launches == launches  # CPU: no kernel
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        assert rel_err(g, w) < TOL["bfloat16"], gname
    single = tbwd.flash_attention_backward(
        tq, tk, tv, None, to_torch(np.asarray(o, np.float32), "bfloat16"),
        to_torch(np.asarray(lse)), tdo, ds_handoff=False, **kw,
    )
    for gname, g, w in zip(("dq", "dk", "dv"), got, single):
        assert rel_err(g, w) < 1e-2, gname


def test_backward_tiers_on_cpu_agree():
    """Handoff and recompute tiers give the same dK / dV (the same bf16
    roundings) and dQ within the fp32 accumulation order."""
    case = CASES["batch2_gqa_bias"]
    x = _inputs(case, seed=1)
    t = {n: to_torch(x[n], "bfloat16") for n in ("q", "k", "v", "do")}
    bias = to_torch(x["bias"])
    kw = dict(scale=1.0 / math.sqrt(320), is_causal=True)
    from ffpa_attn_tpu_torch.ops.flash_fwd import flash_attention_forward

    o, lse = flash_attention_forward(t["q"], t["k"], t["v"], bias, **kw)
    a = tbwd.flash_attention_backward(t["q"], t["k"], t["v"], bias, o, lse, t["do"],
                                      ds_handoff=True, **kw)
    r = tbwd.flash_attention_backward(t["q"], t["k"], t["v"], bias, o, lse, t["do"],
                                      ds_handoff=False, **kw)
    assert torch.equal(a[1], r[1]) and torch.equal(a[2], r[2])
    assert rel_err(a[0], r[0]) < 1e-2
    assert rel_err(a[3], r[3]) < 1e-2


def test_grad_storage_dtypes():
    x = _inputs(CASES["causal"])
    t = {n: to_torch(x[n], "bfloat16") for n in ("q", "k", "v", "do")}
    from ffpa_attn_tpu_torch.ops.flash_fwd import flash_attention_forward

    kw = dict(scale=0.05, is_causal=True)
    o, lse = flash_attention_forward(t["q"], t["k"], t["v"], None, **kw)
    dq, dk, dv, dbias = tbwd.flash_attention_backward(
        t["q"], t["k"], t["v"], None, o, lse, t["do"], grad_kv_storage_dtype="f32",
        grad_q_storage_dtype="f16", **kw)
    assert (dq.dtype, dk.dtype, dv.dtype, dbias) == (torch.float16, torch.float32,
                                                     torch.float32, None)


def test_grad_row_measure_floors_cancelled_rows():
    """A causal row 0 with offset 0 has dQ = 0 up to rounding on both
    sides: the floored measure reads it as noise, not as a failure, while a
    1 % error on a real row still counts."""
    want = np.ones((4, 8), np.float32)
    want[0] = 1e-9
    got = want.copy()
    got[0] = -1e-9
    assert grad_row_rel_err(got, want) < 1e-5
    got[2] *= 1.01
    assert 5e-3 < grad_row_rel_err(got, want) < 2e-2


def _card_inputs(name):
    """Inputs and the port's own plain forward (no JAX on the card's
    machine)."""
    case = CASES[name]
    x = _inputs(case, seed=2)
    dt = case.get("dtype", "bfloat16")
    st = _static(case, x)
    from ffpa_attn_tpu_torch.ops.flash_fwd import flash_attention_forward_plain

    q, k, v, do = (to_torch(x[n], dt) for n in ("q", "k", "v", "do"))
    o, lse = flash_attention_forward_plain(
        q, k, v, to_torch(x["bias"]), scale=st["scale"], is_causal=st["is_causal"],
        dropout_p=st["dropout_p"], dropout_seed=3, softcap=st["softcap"], window=st["window"],
        alibi_slopes=to_torch(x["alibi"]),
    )
    delta = (do.float() * o.float()).sum(-1)
    return x, dict(lse=lse.numpy(), delta=delta.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_dkdv_kernel_matches_plain_on_card(cuda, name):
    case = CASES[name]
    x, j = _card_inputs(name)
    tol = TOL[case.get("dtype", "bfloat16")]
    for emit in (False, True):
        before = tbwd._dkdv_launch.launches
        kdk, kdv, kds = _dkdv(case, x, j, emit, cuda)
        torch.cuda.synchronize()
        assert tbwd._dkdv_launch.launches == before + 1
        pdk, pdv, pds = _dkdv(case, x, j, emit, "cpu")
        assert grad_row_rel_err(kdk, pdk) < tol, "dk"
        assert grad_row_rel_err(kdv, pdv) < tol, "dv"
        if emit:
            assert rel_err(kds, pds) < tol, "ds"


@pytest.mark.parametrize("name", sorted(CASES))
def test_dq_kernel_matches_plain_on_card(cuda, name):
    case = CASES[name]
    x, j = _card_inputs(name)
    tol = TOL[case.get("dtype", "bfloat16")]
    before = tbwd._dq_launch.launches
    kdq, kdb = _dq(case, x, j, cuda)
    torch.cuda.synchronize()
    assert tbwd._dq_launch.launches == before + 1
    pdq, pdb = _dq(case, x, j, "cpu")
    assert grad_row_rel_err(kdq, pdq) < tol
    if pdb is not None:
        assert rel_err(kdb, pdb) < tol


@pytest.mark.parametrize("name", CAUSAL)
def test_banded_dq_kernel_matches_plain_on_card(cuda, name):
    case = CASES[name]
    x, j = _card_inputs(name)
    dt = case.get("dtype", "bfloat16")
    st = _static(case, x)
    _, _, ds = _dkdv(case, x, j, True, cuda)
    nq, nkv = x["q"].shape[2], x["k"].shape[2]
    kw = dict(scale=st["scale"], group=st["group"], nq=nq, nkv=nkv,
              causal_offset=st["causal_offset"], dq_dtype=getattr(torch, dt))
    before = tbwd._banded_dq_from_ds.launches
    got = tbwd._banded_dq_from_ds(ds, to_torch(x["k"], dt, cuda), _config(x, dt), **kw)
    torch.cuda.synchronize()
    assert tbwd._banded_dq_from_ds.launches == before + 1
    want = tbwd._banded_dq_from_ds(ds.cpu(), to_torch(x["k"], dt), _config(x, dt), **kw)
    assert grad_row_rel_err(got, want) < TOL[dt]
