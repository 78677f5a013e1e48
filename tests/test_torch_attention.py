"""The port's attention core against the JAX package's: the visibility
mask for every flag on shared and per-row vectors, and every attention
implementation — masked_attention, attention_ref, the chunked online
softmax and K1's plain version — against JAX's ``attention_ref`` and
``flash_attention(interpret=True)``.

Tolerance: float32 atol 1e-5. Both sides compute in f32 from the same
inputs; outputs are convex combinations of V rows of magnitude ~1, so they
differ only by summation order (a few 1e-7 observed)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import core as jcore
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import core as tcore
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL = 1e-5


def test_sentinels_match():
    assert (tcore.NEG_INF, tcore.PAD_POS, tcore.PAD_SEGMENT, tcore.KERNEL_PAD_SEGMENT) == (
        jcore.NEG_INF, int(jcore.PAD_POS), jcore.PAD_SEGMENT, jcore.KERNEL_PAD_SEGMENT,
    )


def _vectors(rng, B, Lq, Lk, per_row):
    """Positions/segments/contribution vectors with sentinel columns: the
    query block ends the sequence, 4 participants, a few PAD_POS/-1 KV
    slots and -1 query rows."""
    def one():
        kv_pos = np.arange(Lk, dtype=np.int32)
        kv_pos[-3:] = np.iinfo(np.int32).max
        q_pos = np.arange(Lk - Lq, Lk, dtype=np.int32)
        kv_seg = (np.arange(Lk) * 4 // Lk).astype(np.int32)
        kv_seg[rng.integers(0, Lk, 3)] = -1
        q_seg = kv_seg[Lk - Lq:].copy()
        if Lq > 1:
            q_seg[-1] = -1
        contrib = rng.random(Lk) < 0.4
        return q_pos, kv_pos, q_seg, kv_seg, contrib
    rows = [one() for _ in range(B if per_row else 1)]
    out = [np.stack(c) for c in zip(*rows)]
    return out if per_row else [a[0] for a in out]


FLAGS = [
    dict(),
    dict(causal=False),
    dict(window=7),
    dict(local_only=True),
    dict(use_contrib=True),
    dict(local_only=True, use_contrib=True),
    dict(publisher_lo=9),
]


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("segs", [False, True])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "plain")
def test_visibility_equal(per_row, segs, flags):
    rng = np.random.default_rng(1)
    q_pos, kv_pos, q_seg, kv_seg, contrib = _vectors(rng, 3, 20, 40, per_row)
    flags = dict(flags)
    use_contrib = flags.pop("use_contrib", False)
    args = lambda cv: (cv(q_pos), cv(kv_pos), cv(q_seg) if segs else None, cv(kv_seg) if segs else None)
    kw = lambda cv: dict(flags, contributed=cv(contrib) if use_contrib else None)
    got = tcore.visibility(*args(torch.from_numpy), **kw(torch.from_numpy))
    want = jcore.visibility(*args(jnp.asarray), **kw(jnp.asarray))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (B, Lq, Lk, nq, nkv, dh, per_row, kwargs): GQA g ∈ {1, 2, 7}, ragged
# lengths that are not multiples of 64, decode Lq=1.
CASES = {
    "causal_g1": (2, 70, 70, 2, 2, 64, False, dict()),
    "local_g2": (2, 70, 100, 4, 2, 64, False, dict(segs=True, local_only=True)),
    "contrib_g7": (1, 65, 130, 7, 1, 64, False, dict(segs=True, contrib=True)),
    "window_softcap": (2, 33, 90, 4, 2, 32, False, dict(window=17, soft_cap=5.0)),
    "per_row_contrib": (3, 20, 77, 4, 1, 64, True, dict(segs=True, contrib=True)),
    "per_row_local": (3, 20, 77, 4, 4, 64, True, dict(segs=True, local_only=True)),
    "decode": (2, 1, 150, 7, 1, 128, True, dict(segs=True, local_only=True)),
    "bidir": (1, 50, 50, 2, 1, 64, False, dict(causal=False, segs=True, contrib=True)),
}


def _case(name):
    B, Lq, Lk, nq, nkv, dh, per_row, opts = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    q = rng.standard_normal((B, Lq, nq, dh)).astype(np.float32)
    k = rng.standard_normal((B, Lk, nkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, Lk, nkv, dh)).astype(np.float32)
    q_pos, kv_pos, q_seg, kv_seg, contrib = _vectors(rng, B, Lq, Lk, per_row)
    if name == "decode":  # batch row 0's query sees nothing: a fully-masked row
        q_seg[0] = -1
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=opts.get("causal", True))
    if opts.get("segs"):
        kw.update(q_seg=q_seg, kv_seg=kv_seg, local_only=opts.get("local_only", False))
    if opts.get("contrib"):
        kw["contributed"] = contrib
    for key in ("window", "soft_cap"):
        if key in opts:
            kw[key] = opts[key]
    return (q, k, v), kw


def _torch(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _jax(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _run_port(fn, qkv, kw, **extra):
    t = {a: _torch(b) for a, b in kw.items()}
    return fn(*map(torch.from_numpy, qkv), **t, **extra).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_port_attention_matches_jax_ref(name):
    qkv, kw = _case(name)
    want = np.asarray(jref.attention_ref(*map(jnp.asarray, qkv), **{a: _jax(b) for a, b in kw.items()}))
    if name == "decode":  # the fully-masked row gives 0, never NaN
        assert np.all(want[0] == 0) and np.any(want[1] != 0)
    got = {
        "attention_ref": _run_port(tref.attention_ref, qkv, kw),
        "chunked": _run_port(tops._chunked_attention, qkv, kw, chunk=32),
        "plain": _run_port(tfa.flash_attention_plain, qkv, kw),
        "ops_torch": _run_port(tops.attention, qkv, kw, backend="torch", chunk=16),
        "ops_ref": _run_port(tops.attention, qkv, kw, backend="ref"),
    }
    spec = tcore.AttnSpec(**{a: _torch(b) for a, b in kw.items()})
    got["masked_attention"] = tcore.masked_attention(
        *map(torch.from_numpy, qkv), spec.mask(), soft_cap=kw.get("soft_cap"),
    ).numpy()
    for impl, out in got.items():
        assert out.shape == want.shape, impl
        np.testing.assert_allclose(out, want, atol=ATOL, rtol=0, err_msg=impl)


@pytest.mark.parametrize("name", ["local_g2", "per_row_contrib", "window_softcap"])
def test_plain_matches_jax_flash_interpret(name):
    qkv, kw = _case(name)
    want = np.asarray(j_flash(*map(jnp.asarray, qkv), interpret=True, **{a: _jax(b) for a, b in kw.items()}))
    got = _run_port(tfa.flash_attention_plain, qkv, kw)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_masked_attention_stats_combine():
    """Stats over two KV halves combine to the full softmax (the
    flash-decoding form)."""
    qkv, kw = _case("local_g2")
    q, k, v = map(torch.from_numpy, qkv)
    mask = tcore.AttnSpec(**{a: _torch(b) for a, b in kw.items()}).mask()
    h = k.shape[1] // 2
    m1, l1, a1 = tcore.masked_attention(q, k[:, :h], v[:, :h], mask[..., :h], return_stats=True)
    m2, l2, a2 = tcore.masked_attention(q, k[:, h:], v[:, h:], mask[..., h:], return_stats=True)
    m = torch.maximum(m1, m2)
    c1, c2 = torch.exp(m1 - m), torch.exp(m2 - m)
    l = l1 * c1 + l2 * c2
    acc = a1 * c1.transpose(1, 2)[..., None] + a2 * c2.transpose(1, 2)[..., None]
    out = acc / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    want = tcore.masked_attention(q, k, v, mask)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)


def test_kernel_wrapper_on_cpu_runs_plain_and_never_launches():
    qkv, kw = _case("per_row_local")
    launches, calls = tfa.flash_attention.launches, tfa.flash_attention_plain.calls
    got = _run_port(tfa.flash_attention, qkv, kw)
    via_ops = _run_port(tops.attention, qkv, kw, backend="cuda")
    want = _run_port(tfa.flash_attention_plain, qkv, kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(via_ops, want)
    assert tfa.flash_attention.launches == launches
    assert tfa.flash_attention_plain.calls == calls + 3


def test_kernel_wrapper_rejects_mixed_devices():
    qkv, kw = _case("causal_g1")
    q, k, v = map(torch.from_numpy, qkv)
    with pytest.raises(ValueError):
        tfa.flash_attention(q.to("meta"), k, v, **{a: _torch(b) for a, b in kw.items()})
