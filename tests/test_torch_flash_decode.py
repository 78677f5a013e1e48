"""K2's plain version and the port's paged attention paths against the JAX
package: ``paged_flash_decode_plain`` against ``paged_flash_decode_ref``
over page size, GQA ratio, query rows, window, soft-cap, holes, int8/fp8
pools, segments, contributed, publisher_lo and the stats / mass outputs;
once against the Pallas kernel in interpret mode; ``ops.
paged_decode_attention`` on every backend; and the 'attnmass' selection.

Tolerance: f32 atol 1e-5 plus rtol 1e-5 (the unnormalized stats grow with
the number of visible columns). Both sides compute in f32 from the same
inputs and differ by summation order only (a few 1e-7 observed); bitwise
equality is not pinned — the JAX package's own twin pins differ by up to
2.4e-7 on this JAX."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.spmd_attention import decode_exchange_mask as j_decode_exchange_mask
from repro.core.aggregation import contribution_mask as j_contribution_mask
from repro.core.partition import Partition as JPartition
from repro.kernels import core as jcore
from repro.kernels import flash_decode as jfd
from repro.kernels import ops as jops
from repro.serving import quant as jq
from repro_torch.core.aggregation import contribution_mask as t_contribution_mask
from repro_torch.core.aggregation import decode_exchange_mask as t_decode_exchange_mask
from repro_torch.core.partition import Partition as TPartition
from repro_torch.kernels import core as tcore
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.serving import quant as tq

ATOL = RTOL = 1e-5


def _case(seed, *, B=3, S=1, nq=4, nkv=2, dh=64, N=11, ps=4, Pp=5, quant=None, holes=True):
    """Numpy inputs of one paged decode call: 4 participants over the pool
    columns, per-row query positions past the written frontier, a few
    hole (sentinel) table entries and an inactive row whose segments are
    all PAD_SEGMENT."""
    rng = np.random.default_rng(seed)
    Lk = Pp * ps
    d = dict(
        q=rng.standard_normal((B, S, nq, dh)).astype(np.float32),
        pk=rng.standard_normal((N, ps, nkv, dh)).astype(np.float32),
        pv=rng.standard_normal((N, ps, nkv, dh)).astype(np.float32),
        pages=rng.permutation(N)[: B * Pp].reshape(B, Pp).astype(np.int32)
        if B * Pp <= N else rng.integers(0, N, (B, Pp)).astype(np.int32),
    )
    if holes:
        d["pages"][0, -1] = N
        d["pages"][1, 1] = N + 3
    front = rng.integers(Lk // 2, Lk, B)
    d["q_pos"] = (front[:, None] + np.arange(S)[None, :]).astype(np.int32)
    d["kv_pos"] = np.tile(np.arange(Lk, dtype=np.int32), (B, 1))
    kv_seg = np.tile((np.arange(Lk) * 4 // Lk).astype(np.int32), (B, 1))
    kv_seg[-1] = -1  # inactive slot: nothing visible, output exactly 0
    d["kv_seg"] = kv_seg
    d["q_seg"] = np.full((B, S), 3, np.int32)
    d["q_seg"][-1] = -1
    d["contributed"] = rng.random((B, Lk)) < 0.5
    if quant is not None:
        jd = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[quant]
        for name, sname in (("pk", "k_scales"), ("pv", "v_scales")):
            c, s = jq.quantize_block(jnp.asarray(d[name]), jd)
            d[name], d[sname] = np.asarray(c), np.asarray(s)
    return d


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _run(d, flags, fn_t, fn_j, **extra):
    """The same call through the port (torch tensors) and JAX."""
    use_seg, use_c = flags.pop("segments", True), flags.pop("use_contrib", False)
    names = ["q_pos", "kv_pos"] + (["q_seg", "kv_seg"] if use_seg else []) + (
        ["contributed"] if use_c else []) + [n for n in ("k_scales", "v_scales") if n in d]
    args = lambda cv: {n: cv(d[n]) for n in names}
    got = fn_t(*(_to_torch(d[n]) for n in ("q", "pk", "pv", "pages")), **args(_to_torch), **flags, **extra)
    want = fn_j(*(jnp.asarray(d[n]) for n in ("q", "pk", "pv", "pages")), **args(jnp.asarray), **flags, **extra)
    pack = lambda r: r if isinstance(r, tuple) else (r,)
    return pack(got), pack(want)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


# (shape kwargs, flags)
CASES = {
    "decode-g2": (dict(), dict()),
    "verify-S3": (dict(S=3), dict()),
    "local": (dict(), dict(local_only=True)),
    "contributed": (dict(), dict(use_contrib=True)),
    "no-segments-window-softcap": (dict(), dict(segments=False, window=7, soft_cap=2.5)),
    "g4-odd-ps7": (dict(nq=4, nkv=1, ps=7, Pp=4), dict(use_contrib=True)),
    "g1-ps16": (dict(nq=2, nkv=2, ps=16, Pp=3, N=9), dict()),
    "publisher-lo": (dict(S=2), dict(publisher_lo=5)),
    "int8": (dict(quant="int8"), dict()),
    "fp8-verify": (dict(quant="fp8", S=2), dict(use_contrib=True)),
    "no-holes-dh128": (dict(dh=128, holes=False), dict()),
}


@pytest.mark.parametrize("outputs", ["out", "stats", "mass", "stats+mass"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_ref(name, outputs):
    shape, flags = CASES[name]
    d = _case(hash(name) % 1000, **shape)
    extra = dict(return_stats="stats" in outputs, return_mass="mass" in outputs)
    got, want = _run(d, dict(flags), tfd.paged_flash_decode_plain, jfd.paged_flash_decode_ref, **extra)
    _close(got, want)
    if not extra["return_stats"] and flags.get("segments", True):
        assert (got[0][-1] == 0).all()  # the inactive slot's rows are exactly 0


def test_plain_matches_pallas_interpret():
    d = _case(5, S=2, quant="int8")
    pallas = lambda *a, **kw: jfd.paged_flash_decode(*a, interpret=True, **kw)
    got, want = _run(d, dict(use_contrib=True), tfd.paged_flash_decode_plain, pallas,
                     return_mass=True)
    _close(got, want)


def test_wrapper_takes_plain_version_on_cpu():
    d = _case(2)
    launches, calls = tfd.paged_flash_decode.launches, tfd.paged_flash_decode_plain.calls
    got, want = _run(d, dict(), tfd.paged_flash_decode, jfd.paged_flash_decode_ref)
    _close(got, want)
    assert tfd.paged_flash_decode.launches == launches
    assert tfd.paged_flash_decode_plain.calls == calls + 1


def test_split_count_fills_the_card():
    assert tfd.split_count(16, 4, 128) == (9, 15)  # the pool's shape: 576 blocks
    assert tfd.split_count(1, 1, 3) == (3, 1)
    n, per = tfd.split_count(64, 8, 50)
    assert n * per >= 50 and (n - 1) * per < 50


@pytest.mark.parametrize("backend", ["torch", "ref", "cuda"])
@pytest.mark.parametrize("mass", [False, True])
@pytest.mark.parametrize("quant", [None, "fp8"])
def test_paged_decode_attention_backends(backend, mass, quant):
    """ops.paged_decode_attention against the JAX 'xla' route: the port's
    'torch' and 'ref' routes gather pages in plain torch, 'cuda' reaches
    K2's plain version for CPU tensors."""
    d = _case(9, S=2, quant=quant, Pp=6, N=20)
    got, want = _run(d, dict(use_contrib=True), tops.paged_decode_attention,
                     jops.paged_decode_attention, return_mass=mass)
    _close(got, want)


def test_chunked_paged_attention_matches_jax():
    """The large 'torch' path: page groups streamed through the online
    softmax (Lq * Lk above the densify threshold)."""
    d = _case(11, B=2, S=40, nq=2, nkv=1, ps=16, Pp=110, N=230)
    got, want = _run(d, dict(), tops.paged_attention, jops.paged_attention, chunk=256)
    _close(got, want)


def test_paged_attention_refuses_cuda():
    """On 'cuda' the paged read is K2's alone (paged_decode_attention)."""
    d = _case(2)
    with pytest.raises(ValueError, match="K2"):
        _run(d, dict(), tops.paged_attention, jops.paged_attention, backend="cuda")


def test_masked_attention_return_probs():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    mask = rng.random((2, 5, 9)) < 0.6
    got = tcore.masked_attention(*map(torch.from_numpy, (q, k, v, mask)), return_stats=True, return_probs=True)
    want = jcore.masked_attention(*map(jnp.asarray, (q, k, v, mask)), return_stats=True, return_probs=True)
    _close(got, want)


@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.9])
def test_decode_exchange_mask_matches_jax(ratio):
    """Top-k columns by accumulated mass, ties (zeros: holes, padding) to
    the lower column first."""
    rng = np.random.default_rng(int(ratio * 10))
    mass = rng.random((3, 40)).astype(np.float32) * (rng.random((3, 40)) < 0.5)
    mass[1, 5:9] = mass[1, 20]  # ties among non-zero masses too
    got = t_decode_exchange_mask(torch.from_numpy(mass), ratio)
    want = j_decode_exchange_mask(jnp.asarray(mass), ratio)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_mass", [False, True])
def test_attnmass_contribution_mask_matches_jax(with_mass):
    sizes = [7, 9, 5, 11]
    mass = np.random.default_rng(4).random(32).astype(np.float32)
    got = t_contribution_mask(
        TPartition.from_sizes(sizes), 0.4, "attnmass",
        attn_mass=torch.from_numpy(mass) if with_mass else None,
    )
    want = j_contribution_mask(
        JPartition.from_sizes(sizes), 0.4, "attnmass",
        attn_mass=jnp.asarray(mass) if with_mass else None,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
