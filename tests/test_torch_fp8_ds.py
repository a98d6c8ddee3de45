"""fp8 (e4m3) storage of the dS-handoff slab against the JAX package.

The same numpy inputs go to both packages: JAX runs its Pallas kernels in
interpret mode, the port (on the CPU) its plain versions; both backwards
get the JAX forward's (o, lse). Shape B1 H2 Nq256 Nkv384 D320 bf16, the JAX
test's (``tests/test_ffpa_bwd.py:650``) cut to fewer rows.

Tolerances and rules:

* dQ of the e4m3 handoff against JAX's at the bf16 gradient contract 5e-2;
  the port's plain slab within one e4m3 step of JAX's (the two fp32 dS
  differ in summation order only);
* dK and dV bit-equal to the port's own 16-bit run (both take the 16-bit
  dS), as JAX asserts for its own;
* the JAX test's bounds on e4m3 against 16-bit dQ (RMS 4e-2, worst 8e-2)
  and against the fp32 oracle (8e-2);
* the four cases that keep 16 bits (flag unset, fp16 cotangent, a bias,
  fp16 inputs) bit-equal to the 16-bit run; the S-resident tier never
  stores fp8;
* past e4m3's range the port saturates to +-448 (JAX's ``astype`` gives
  NaN there), the same in ``quantize_e4m3`` and in ``_dkdv_plain``.

On the card (``-k on_card``) the e4m3 writer and reader are held to their
plain versions: dK and dV bit-equal to the 16-bit-slab launch, the slab
within one e4m3 step, banded dQ per row at 2e-2 on the kernel's own slab.
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, grad_row_rel_err, jax_modules, randn, rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import dispatch as tdispatch
from ffpa_attn_tpu_torch.ops import flash_bwd as tbwd
from ffpa_attn_tpu_torch.ops.config import (
    DKDV_Q_TILE, DKDV_SLAB_COLS, SMEM_LIMIT_BYTES, BlockConfig, banded_plan, cdiv,
)
from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config

TOL = 5e-2
B, H, NQ, NKV, D = 1, 2, 256, 384, 320
CFG16, CFG8 = BlockConfig(), BlockConfig(ds_store_bits=8)


@pytest.fixture
def flags(monkeypatch):
    """The opt-in set in both packages."""
    monkeypatch.setenv("FFPA_TORCH_ALLOW_FP8_DS", "1")
    monkeypatch.setenv("FFPA_TPU_ALLOW_FP8_DS", "1")


@pytest.fixture(scope="module")
def jax_ready():
    jax_modules("jax", "ffpa_attn_tpu.ops.flash_bwd")


def _inputs(seed=0, nq=NQ, nkv=NKV, d=D, bias=False):
    rng = np.random.default_rng(seed)
    x = dict(q=randn(rng, (B, H, nq, d)), k=randn(rng, (B, H, nkv, d)),
             v=randn(rng, (B, H, nkv, d)), do=randn(rng, (B, H, nq, d)))
    x["bias"] = randn(rng, (B, 1, nq, nkv)) if bias else None
    return x


def _jax_forward(x, causal, dtype="bfloat16"):
    """JAX's (o, lse) of x as numpy, and its inputs as JAX arrays."""
    from ffpa_attn_tpu.ops import flash_fwd as jfwd

    j = {n: to_jax(x[n], dtype) for n in ("q", "k", "v", "do")}
    j["bias"] = to_jax(x["bias"])
    scale = 1.0 / math.sqrt(x["q"].shape[-1])
    o, lse = jfwd.flash_attention_forward(j["q"], j["k"], j["v"], j["bias"], scale=scale,
                                          is_causal=causal)
    return j, np.asarray(o, np.float32), np.asarray(lse, np.float32)


def _port_backward(x, o, lse, causal, config, dtype="bfloat16", do_dtype=None, **kw):
    t = {n: to_torch(x[n], dtype) for n in ("q", "k", "v")}
    do = to_torch(x["do"], do_dtype or dtype)
    return tbwd.flash_attention_backward(
        t["q"], t["k"], t["v"], to_torch(x["bias"]), to_torch(o, dtype), to_torch(lse), do,
        scale=1.0 / math.sqrt(x["q"].shape[-1]), is_causal=causal, config=config,
        ds_handoff=True, **kw)


def _plain_forward(x, causal, dtype="bfloat16"):
    """The port's own plain forward (for the tests that need no JAX)."""
    from ffpa_attn_tpu_torch.ops.flash_fwd import flash_attention_forward_plain

    t = {n: to_torch(x[n], dtype) for n in ("q", "k", "v")}
    o, lse = flash_attention_forward_plain(t["q"], t["k"], t["v"], to_torch(x["bias"]),
                                           scale=1.0 / math.sqrt(x["q"].shape[-1]),
                                           is_causal=causal)
    return o.float().numpy(), lse.numpy()


def _equal(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a, b) if p is not None or q is not None)


def _as_e4m3(a):
    """A numpy array of e4m3 values (float32 or ml_dtypes) as a torch e4m3
    tensor: exact, every value is on the grid."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.float8_e4m3fn)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_fp8_handoff_dq_matches_jax(jax_ready, flags, causal):
    from ffpa_attn_tpu.ops import flash_bwd as jbwd
    from ffpa_attn_tpu.ops.config import BlockConfig as JBlockConfig

    x = _inputs()
    j, o, lse = _jax_forward(x, causal)
    want = jbwd.flash_attention_backward(
        j["q"], j["k"], j["v"], None, to_jax(o, "bfloat16"), to_jax(lse), j["do"],
        scale=1.0 / math.sqrt(D), is_causal=causal, ds_handoff=True,
        config=JBlockConfig(ds_store_bits=8))
    got = _port_backward(x, o, lse, causal, CFG8)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert rel_err(g, w) < TOL, name


@pytest.mark.parametrize("causal", [False, True])
def test_fp8_slab_within_one_step_of_jax(jax_ready, causal):
    """The port's plain e4m3 slab against JAX's ``_dkdv_launch`` with
    ``ds_store_bits=8`` on the same inputs: every element within one e4m3
    step (most equal), padding zero."""
    import jax.numpy as jnp
    from ffpa_attn_tpu.ops import flash_bwd as jbwd
    from ffpa_attn_tpu.ops.config import BlockConfig as JBlockConfig

    x = _inputs(seed=1)
    j, o, lse = _jax_forward(x, causal)
    jdelta = jnp.sum(j["do"].astype(jnp.float32) * to_jax(o, "bfloat16").astype(jnp.float32),
                     axis=-1)
    scale, off = 1.0 / math.sqrt(D), NKV - NQ
    kw = dict(scale=scale, is_causal=causal, causal_offset=off, dropout_p=0.0, group=1)
    _, _, jds = jbwd._dkdv_launch(
        j["q"], j["k"], j["v"], None, j["do"], to_jax(lse), jdelta,
        jnp.asarray(0, jnp.int32).reshape(1, 1), JBlockConfig(ds_store_bits=8).clamp(NQ, NKV),
        grad_kv_storage_dtype=None, emit_ds=True, interpret=True, **kw)
    assert jds.dtype == jnp.float8_e4m3fn
    t = {n: to_torch(x[n], "bfloat16") for n in ("q", "k", "v", "do")}
    dk, dv, ds = tbwd._dkdv_launch(
        t["q"], t["k"], t["v"], None, t["do"], to_torch(lse),
        (t["do"].float() * to_torch(o, "bfloat16").float()).sum(-1), 0, CFG8,
        grad_kv_storage_dtype=None, emit_ds=True, **kw)
    assert ds.dtype == torch.float8_e4m3fn
    assert ds.shape[2] % DKDV_Q_TILE == 0 and ds.shape[3] % DKDV_SLAB_COLS == 0
    steps = tbwd.e4m3_steps(ds[:, :, :NQ, :NKV], _as_e4m3(np.asarray(jds)[:, :, :NQ, :NKV]))
    assert int(steps.max()) <= 1
    assert float((steps == 0).float().mean()) > 0.99
    assert not ds[:, :, NQ:].float().any() and not ds[:, :, :, NKV:].float().any()
    # dK and dV are those of the 16-bit slab's launch, bit for bit.
    dk16, dv16, ds16 = tbwd._dkdv_launch(
        t["q"], t["k"], t["v"], None, t["do"], to_torch(lse),
        (t["do"].float() * to_torch(o, "bfloat16").float()).sum(-1), 0, CFG16,
        grad_kv_storage_dtype=None, emit_ds=True, **kw)
    assert ds16.dtype == torch.bfloat16
    assert torch.equal(dk, dk16) and torch.equal(dv, dv16)


@pytest.mark.parametrize("causal", [False, True])
def test_fp8_dk_dv_bit_equal_to_16bit_run(flags, causal):
    x = _inputs(seed=2)
    o, lse = _plain_forward(x, causal)
    r16 = _port_backward(x, o, lse, causal, CFG16)
    r8 = _port_backward(x, o, lse, causal, CFG8)
    assert torch.equal(r8[1], r16[1]) and torch.equal(r8[2], r16[2])
    assert not torch.equal(r8[0], r16[0])  # dQ read the e4m3 slab


@pytest.mark.parametrize("causal", [False, True])
def test_fp8_within_the_jax_tests_bounds(flags, causal):
    """``tests/test_ffpa_bwd.py:685-699``: e4m3 dQ against the 16-bit run,
    RMS < 4e-2 and worst element < 8e-2; against the fp32 oracle < 8e-2."""
    from ffpa_attn_tpu_torch.ops.reference import reference_attention

    x = _inputs(seed=3)
    o, lse = _plain_forward(x, causal)
    g16 = _port_backward(x, o, lse, causal, CFG16)[0].float()
    g8 = _port_backward(x, o, lse, causal, CFG8)[0].float()
    rms = float((g8 - g16).pow(2).mean().sqrt() / (g16.pow(2).mean().sqrt() + 1e-9))
    assert rms < 4e-2
    assert rel_err(g8, g16) < 8e-2
    q = to_torch(x["q"], "bfloat16").float().requires_grad_()
    k, v = (to_torch(x[n], "bfloat16").float() for n in ("k", "v"))
    out = reference_attention(q, k, v, None, is_causal=causal, scale=1.0 / math.sqrt(D))
    (gq,) = torch.autograd.grad(out, q, to_torch(x["do"], "bfloat16").float())
    assert rel_err(g8, gq) < 8e-2


@pytest.mark.parametrize("case", ["flag_unset", "f16_cotangent", "bias", "f16_inputs"])
def test_fp8_request_keeps_16_bits(monkeypatch, case):
    """The four cases of the JAX package's rule (``flash_bwd.py:961-977``):
    ``ds_store_bits=8`` asked for, 16 bits stored, every output bit-equal to
    the 16-bit run."""
    monkeypatch.setenv("FFPA_TORCH_ALLOW_FP8_DS", "0" if case == "flag_unset" else "1")
    x = _inputs(seed=4, bias=case == "bias")
    dtype = "float16" if case == "f16_inputs" else "bfloat16"
    do_dtype = "float16" if case == "f16_cotangent" else None
    o, lse = _plain_forward(x, True, dtype)
    seen = []
    launch = tbwd._dkdv_launch

    def spy(*a, **kw):
        out = launch(*a, **kw)
        seen.append(out[2].dtype)
        return out

    monkeypatch.setattr(tbwd, "_dkdv_launch", spy)
    r8 = _port_backward(x, o, lse, True, CFG8, dtype, do_dtype)
    r16 = _port_backward(x, o, lse, True, CFG16, dtype, do_dtype)
    assert _equal(r8, r16)
    assert seen and torch.float8_e4m3fn not in seen


def test_s_resident_tier_never_stores_fp8(flags):
    """With the forward's S residual the slab is S itself (bf16, written in
    place): ``ds_store_bits=8`` changes nothing."""
    from ffpa_attn_tpu_torch.ops.flash_fwd import flash_attention_forward

    x = _inputs(seed=5)
    t = {n: to_torch(x[n], "bfloat16") for n in ("q", "k", "v", "do")}
    scale = 1.0 / math.sqrt(D)
    runs = []
    for cfg in (CFG16, CFG8):
        o, lse, s = flash_attention_forward(t["q"], t["k"], t["v"], None, scale=scale,
                                            is_causal=True, return_scores=True)
        runs.append(tbwd.flash_attention_backward(
            t["q"], t["k"], t["v"], None, o, lse, t["do"], scale=scale, is_causal=True,
            config=cfg, scores=s))
        assert s.dtype == torch.bfloat16
    assert _equal(*runs)


# The cases of tests/test_ffpa_bwd.py:719-741 as dispatch arguments: the
# default (no opt-in), a big bf16 task, a small one, an fp16 task (the
# cotangent or the inputs), a biased one, and the edge of Nq * Nkv >= 4096^2.
DISPATCH = {
    "default_no_optin": dict(nq=8192, nkv=8192, flag="0"),
    "big": dict(nq=8192, nkv=8192),
    "small": dict(nq=1024, nkv=1024),
    "f16_cotangent": dict(nq=8192, nkv=8192, f16=True),
    "f16_inputs": dict(nq=8192, nkv=8192, dtype="float16"),
    "biased": dict(nq=8192, nkv=8192, has_bias=True),
    "at_4096_squared": dict(nq=4096, nkv=4096),
    "below_4096_squared": dict(nq=4095, nkv=4096),
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch_proposes_fp8_as_jax_does(jax_ready, monkeypatch, name):
    import jax.numpy as jnp
    from ffpa_attn_tpu.ops.dispatch import pick_backward_config as jpick

    case = dict(DISPATCH[name])
    flag = case.pop("flag", "1")
    monkeypatch.setenv("FFPA_TORCH_ALLOW_FP8_DS", flag)
    monkeypatch.setenv("FFPA_TPU_ALLOW_FP8_DS", flag)
    dtype = case.pop("dtype", "bfloat16")
    got = pick_backward_config(d=512, dv=512, dtype=getattr(torch, dtype), **case)
    want = jpick(d=512, dv=512, dtype=getattr(jnp, dtype), causal=True,
                 **dict(dict(has_bias=False), **case))
    assert got.ds_store_bits == want.ds_store_bits
    assert got.ds_store_bits == (8 if name in ("big", "at_4096_squared") else 16)


def test_striped_fp8_handoff_matches_jax(jax_ready, flags, monkeypatch):
    """A slab limit between the e4m3 slab and the bf16 one: 16 bits take two
    KV stripes, e4m3 one, in both packages; dQ against JAX's at the same
    limit."""
    from ffpa_attn_tpu.ops import flash_bwd as jbwd
    from ffpa_attn_tpu.ops.config import BlockConfig as JBlockConfig

    nq, nkv = 256, 512  # multiples of both packages' slab tiles
    limit = B * H * nq * nkv * 3 // 2  # e4m3 slab: B H nq nkv bytes; bf16: twice
    monkeypatch.setenv("FFPA_TORCH_DS_HANDOFF_LIMIT_BYTES", str(limit))
    monkeypatch.setenv("FFPA_TPU_DS_HANDOFF_LIMIT_BYTES", str(limit))
    x = _inputs(seed=6, nq=nq, nkv=nkv)
    j, o, lse = _jax_forward(x, True)
    stripes = {"port": [], "jax": []}
    for mod, key in ((tbwd, "port"), (jbwd, "jax")):
        launch = mod._dkdv_launch

        def spy(*a, _launch=launch, _key=key, **kw):
            stripes[_key].append(kw.get("col_offset", 0))
            return _launch(*a, **kw)

        monkeypatch.setattr(mod, "_dkdv_launch", spy)
    counts = {}
    for bits in (16, 8):
        for key in stripes:
            stripes[key].clear()
        got = _port_backward(x, o, lse, True, BlockConfig(ds_store_bits=bits))
        want = jbwd.flash_attention_backward(
            j["q"], j["k"], j["v"], None, to_jax(o, "bfloat16"), to_jax(lse), j["do"],
            scale=1.0 / math.sqrt(D), is_causal=True, ds_handoff=True,
            config=JBlockConfig(ds_store_bits=bits))
        counts[bits] = (len(stripes["port"]), len(stripes["jax"]))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert rel_err(g, w) < TOL, (bits, name)
    assert counts == {16: (2, 2), 8: (1, 1)}


# ---------------------------------------------------------------------------
# The overflow rule, the readers, the plan
# ---------------------------------------------------------------------------


def test_e4m3_rule_saturates_where_jax_gives_nan(jax_ready):
    import jax.numpy as jnp

    vals = [1000.0, -1000.0, 449.0, 460.0, 465.0, float("inf"), -float("inf"), 9.7e-4,
            2.0 ** -10, 3 * 2.0 ** -11, 1.0625, 1.1875]
    got = tbwd.quantize_e4m3(torch.tensor(vals)).float().tolist()
    assert got == [448.0, -448.0, 448.0, 448.0, 448.0, 448.0, -448.0, 0.0, 0.0, 2.0 ** -9,
                   1.0, 1.25]  # ties to even: 1.0625 -> 1.0, 1.1875 -> 1.25
    assert math.isnan(tbwd.quantize_e4m3(torch.tensor([float("nan")])).float().item())
    jax_got = np.asarray(jnp.asarray([1000.0, 449.0], jnp.float32).astype(jnp.float8_e4m3fn),
                         np.float32)
    assert math.isnan(jax_got[0]) and jax_got[1] == 448.0  # the deliberate difference


def test_dkdv_plain_slab_saturates_by_the_rule():
    """A dS past +-448 (a cotangent scaled up): the plain version's e4m3
    slab is ``quantize_e4m3`` of its fp32 dS, saturated, with no NaN."""
    x = _inputs(seed=7, nq=128, nkv=128)
    x["do"] = x["do"] * 2000.0
    o, lse = _plain_forward(x, True)
    t = {n: to_torch(x[n], "bfloat16") for n in ("q", "k", "v", "do")}
    delta = (t["do"].float() * to_torch(o, "bfloat16").float()).sum(-1)
    kw = dict(is_causal=True, causal_offset=0, dropout_p=0.0, seed=0, softcap=0.0,
              window=(-1, -1), alibi=None)
    scale = 1.0 / math.sqrt(D)
    _, _, ds = tbwd._dkdv_plain(t["q"], t["k"], t["v"], None, t["do"], to_torch(lse), delta,
                                scale=scale, emit_ds=True, nq_pad=128, nkv_pad=128,
                                ds_fp8=True, **kw)
    _, _, ds_qk = tbwd._score_grads_plain(t["q"], t["k"], t["v"], t["do"], to_torch(lse), delta,
                                          None, scale=scale, **kw)
    assert float(ds_qk.abs().max()) > 448.0 * 4
    assert torch.equal(ds.view(torch.uint8), tbwd.quantize_e4m3(ds_qk).view(torch.uint8))
    assert float(ds.float().abs().max()) == 448.0 and not ds.float().isnan().any()


def test_e4m3_readers_widen_exactly(flags):
    """Banded dQ and the non-causal product over an e4m3 slab equal the same
    over the slab widened to bf16, bit for bit."""
    rng = np.random.default_rng(8)
    nq_pad, nkv_pad = cdiv(NQ, DKDV_Q_TILE) * DKDV_Q_TILE, NKV
    ds8 = torch.from_numpy(randn(rng, (B, H, nq_pad, nkv_pad), 0.1)).to(torch.float8_e4m3fn)
    ds16 = ds8.to(torch.bfloat16)
    k = to_torch(randn(rng, (B, H, NKV, D)), "bfloat16")
    kw = dict(scale=0.05, group=1, nq=NQ, nkv=NKV)
    a = tbwd._banded_dq_from_ds(ds8, k, CFG8, causal_offset=NKV - NQ, dq_dtype=torch.float32,
                                **kw)
    b = tbwd._banded_dq_from_ds(ds16, k, CFG16, causal_offset=NKV - NQ, dq_dtype=torch.float32,
                                **kw)
    assert torch.equal(a, b)
    a, _ = tbwd._dq_from_ds(ds8, k, None, dq_dtype=torch.float32, **kw)
    b, _ = tbwd._dq_from_ds(ds16, k, None, dq_dtype=torch.float32, **kw)
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        tbwd._banded_dq_from_ds(ds8, k.half(), CFG8, causal_offset=0, dq_dtype=torch.float32,
                                **kw)


@pytest.mark.parametrize("dtype,cols,ok", [
    (torch.float8_e4m3fn, 16, True), (torch.float8_e4m3fn, 8, False),
    (torch.bfloat16, 8, True), (torch.bfloat16, 4, False)])
def test_banded_slab_rows_are_16_byte_multiples(dtype, cols, ok):
    ds = torch.zeros((1, 1, 64, cols), dtype=dtype)
    if ok:
        tbwd._check_banded_slab("banded dQ", ds)
    else:
        with pytest.raises(ValueError):
            tbwd._check_banded_slab("banded dQ", ds)


@pytest.mark.parametrize("bits,ok", [(8, True), (16, True), (4, False), (32, False)])
def test_ds_store_bits_validated(bits, ok):
    if ok:
        assert BlockConfig(ds_store_bits=bits).ds_store_bits == bits
    else:
        with pytest.raises(ValueError):
            BlockConfig(ds_store_bits=bits)


def test_banded_plan_e4m3_stage():
    """Over an e4m3 slab a stage holds the 8 KB 1-byte dS tile beside the
    16-bit tile it is widened into; four stages still fit at every D."""
    for d in range(64, 1025, 64):
        p16, p8 = banded_plan(d), banded_plan(d, ds_itemsize=1)
        assert p8.col_blocks == p16.col_blocks and p8.stages == p16.stages == 4
        assert p8.smem_bytes == p16.smem_bytes + 4 * 128 * 64
        assert p8.smem_bytes <= SMEM_LIMIT_BYTES
    assert banded_plan(512, ds_itemsize=2) == banded_plan(512)


def test_autograd_takes_fp8_where_dispatch_proposes_it(flags, monkeypatch):
    """``ffpa_attn_func``'s backward (the dS handoff, config left to the
    dispatcher) stores e4m3 where the rule proposes it: here the size
    threshold lowered to 0. Its gradients equal ``flash_attention_backward``
    with ``ds_store_bits=8``, dK and dV the 16-bit run's."""
    from ffpa_attn_tpu_torch import ffpa_attn_func
    from ffpa_attn_tpu_torch.functional import CudaBackend

    monkeypatch.setattr(tdispatch, "FP8_DS_MIN_PAIRS", 0)
    x = _inputs(seed=9)
    t = {n: to_torch(x[n], "bfloat16").requires_grad_() for n in ("q", "k", "v")}
    out = ffpa_attn_func(t["q"], t["k"], t["v"], is_causal=True, scale=1.0 / math.sqrt(D),
                         backend=CudaBackend(save_scores=False, ds_handoff=True))
    got = torch.autograd.grad(out, (t["q"], t["k"], t["v"]), to_torch(x["do"], "bfloat16"))
    o, lse = _plain_forward(x, True)
    r8 = _port_backward(x, o, lse, True, CFG8)
    r16 = _port_backward(x, o, lse, True, CFG16)
    assert _equal(got, r8[:3])
    assert torch.equal(got[1], r16[1]) and not torch.equal(got[0], r16[0])


# ---------------------------------------------------------------------------
# On the card: the e4m3 writer and reader against their plain versions
# ---------------------------------------------------------------------------

CARD = {
    "causal_d512": dict(nq=1024, nkv=1024, d=512, hq=8, hkv=4),
    "ragged_d320": dict(nq=1000, nkv=1100, d=320, hq=4, hkv=2),
    "noncausal_d512": dict(nq=512, nkv=640, d=512, hq=4, hkv=4, causal=False),
    "cluster_d1024": dict(nq=1024, nkv=1024, d=1024, hq=8, hkv=4),
    "cluster_d640_ragged": dict(nq=1000, nkv=1100, d=640, hq=4, hkv=4),
}


def _card_case(name, device):
    c = CARD[name]
    causal = c.get("causal", True)
    rng = np.random.default_rng(10)
    shapes = dict(q=(1, c["hq"], c["nq"], c["d"]), k=(1, c["hkv"], c["nkv"], c["d"]),
                  v=(1, c["hkv"], c["nkv"], c["d"]), do=(1, c["hq"], c["nq"], c["d"]))
    t = {n: to_torch(randn(rng, s), "bfloat16", device) for n, s in shapes.items()}
    from ffpa_attn_tpu_torch.ops.flash_fwd import flash_attention_forward

    scale = 1.0 / math.sqrt(c["d"])
    o, lse = flash_attention_forward(t["q"], t["k"], t["v"], None, scale=scale, is_causal=causal)
    delta = (t["do"].float() * o.float()).sum(-1)
    kw = dict(scale=scale, is_causal=causal, causal_offset=c["nkv"] - c["nq"], dropout_p=0.0,
              group=c["hq"] // c["hkv"])
    return c, causal, t, lse, delta, kw


@pytest.mark.parametrize("name", sorted(CARD))
def test_e4m3_writer_matches_plain_on_card(cuda, name):
    c, causal, t, lse, delta, kw = _card_case(name, cuda)
    args = (t["q"], t["k"], t["v"], None, t["do"], lse, delta, 0)
    dk16, dv16, _ = tbwd._dkdv_launch(*args, CFG16, grad_kv_storage_dtype=None, emit_ds=True, **kw)
    before = tbwd._dkdv_launch.fp8_launches
    dk8, dv8, ds8 = tbwd._dkdv_launch(*args, CFG8, grad_kv_storage_dtype=None, emit_ds=True, **kw)
    torch.cuda.synchronize()
    assert tbwd._dkdv_launch.fp8_launches == before + 1
    assert ds8.dtype == torch.float8_e4m3fn
    assert torch.equal(dk8, dk16) and torch.equal(dv8, dv16)
    _, _, pds = tbwd._dkdv_plain(
        t["q"], t["k"], t["v"], None, t["do"], lse, delta, scale=kw["scale"], emit_ds=True,
        nq_pad=ds8.shape[2], nkv_pad=ds8.shape[3], ds_fp8=True, is_causal=causal,
        causal_offset=kw["causal_offset"], dropout_p=0.0, seed=0, softcap=0.0, window=(-1, -1),
        alibi=None)
    assert int(tbwd.e4m3_steps(ds8, pds).max()) <= 1


@pytest.mark.parametrize("name", sorted(n for n, c in CARD.items() if c.get("causal", True)))
def test_e4m3_reader_matches_plain_on_card(cuda, name):
    c, _, t, lse, delta, kw = _card_case(name, cuda)
    _, _, ds8 = tbwd._dkdv_launch(t["q"], t["k"], t["v"], None, t["do"], lse, delta, 0, CFG8,
                                  grad_kv_storage_dtype=None, emit_ds=True, **kw)
    before = tbwd._banded_dq_from_ds.fp8_launches
    got = tbwd._banded_dq_from_ds(ds8, t["k"], CFG8, scale=kw["scale"], group=kw["group"],
                                  nq=c["nq"], nkv=c["nkv"], causal_offset=kw["causal_offset"],
                                  dq_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert tbwd._banded_dq_from_ds.fp8_launches == before + 1
    want = tbwd._banded_dq_plain(ds8, t["k"], scale=kw["scale"], nq=c["nq"], nkv=c["nkv"])
    assert grad_row_rel_err(got, want) < 2e-2
