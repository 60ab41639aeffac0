"""The Hopper design of the eproj and span backward (kernels 6 and 9,
`csrc/attn_eproj_bwd.cuh`) where the CPU can hold it: the edge-balanced
target tiles its wrappers pass the kernel (`attention_eproj.bwd_tile_ptr`),
and the 3xTF32 split its f32 products use on the tensor cores, emulated in
numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnnep_tpu_torch.ops.cuda import attention_eproj as ep  # noqa: E402
from gnnep_tpu_torch.utils.synth import flagship_batch  # noqa: E402


def _row_ptr(degs):
    return np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)


def _flagship_lg():
    return np.asarray(flagship_batch().lg_row_ptr, np.int32)


def _hub():
    """A hub target with 1,500 in-edges among rows of 0-9."""
    degs = np.random.default_rng(0).integers(0, 10, 300)
    degs[137] = 1500
    degs[-1] = 40          # the dummy row's tail
    return _row_ptr(degs)


ROW_PTRS = {
    "empty_rows": lambda: _row_ptr([0, 3, 0, 0, 5, 1, 0, 2, 0, 7]),
    "hub_row": _hub,
    "all_edges_in_dummy_row": lambda: _row_ptr([0] * 12 + [90]),
    "n1_only_dummy": lambda: _row_ptr([17]),
    "no_edges": lambda: _row_ptr([0] * 5),
    "flagship_lg": _flagship_lg,
}


@pytest.mark.parametrize("tiles", [1, 7, 66])
@pytest.mark.parametrize("case", sorted(ROW_PTRS))
def test_tiles_cover_every_real_target_once(case, tiles):
    """Tiles are contiguous and in order, cover targets 0..n-2 exactly once
    and never the dummy row n-1; a tile holds at most ⌈E_live/tiles⌉ edges
    plus its last target's in-degree, so at most twice the larger of the
    mean and its longest row."""
    rp = ROW_PTRS[case]()
    n = rp.shape[0] - 1
    ptr = ep.bwd_tile_ptr(torch.from_numpy(rp), tiles)
    assert ptr.dtype == torch.int32 and tuple(ptr.shape) == (tiles + 1,)
    ptr = ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == max(n - 1, 0)
    assert (np.diff(ptr) >= 0).all()
    covered = np.concatenate([np.arange(a, b) for a, b in zip(ptr, ptr[1:])])
    np.testing.assert_array_equal(covered, np.arange(max(n - 1, 0)))
    deg = np.diff(rp)
    per = -(-int(rp[max(n - 1, 0)]) // tiles)
    for a, b in zip(ptr, ptr[1:]):
        edges = int(rp[b] - rp[a])
        last = int(deg[b - 1]) if b > a else 0
        assert edges <= per + last, (a, b, edges, per, last)
        longest = int(deg[a:b].max()) if b > a else 0
        assert edges <= 2 * max(per, longest)


def test_hub_tile_is_long_and_the_rest_balanced():
    """The hub's 1,500 edges sit in one tile; every tile without it stays
    within the per-tile share plus one row of at most 9 edges."""
    rp = _hub()
    tiles = 20
    ptr = ep.bwd_tile_ptr(torch.from_numpy(rp), tiles).numpy()
    per = -(-int(rp[-2]) // tiles)
    sizes = [(a, b, int(rp[b] - rp[a])) for a, b in zip(ptr, ptr[1:])]
    hub = [s for s in sizes if s[0] <= 137 < s[1]]
    assert len(hub) == 1 and hub[0][2] >= 1500
    assert all(e <= per + 9 for a, b, e in sizes if not a <= 137 < b)


@pytest.mark.parametrize("n,heads,sms,want", [
    (7552, 4, 132, 66), (768, 4, 132, 66), (40, 2, 132, 39), (1, 4, 132, 1),
    (2, 1, 132, 1), (100000, 1, 114, 228)])
def test_bwd_tiles_make_one_wave(n, heads, sms, want):
    """2·SMs blocks over (tiles, heads), no more tiles than real targets."""
    assert ep.bwd_tiles(n, heads, sms) == want


# ------------------------------------------------------------- 3xTF32
def _tf32(x):
    """cvt.rna.tf32.f32: round to the nearest value with 10 mantissa bits,
    ties away from zero."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _ffma(a, b):
    """The FFMA design's order: one fused multiply-add per k into an f32
    accumulator (the exact product added in float64, rounded once)."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc + a[:, k:k + 1].astype(np.float64)
               * b[k:k + 1].astype(np.float64)).astype(np.float32)
    return acc


def _tiled(a, b, terms):
    """The kernel's order: a running f32 tile over k-steps of 8, each step
    adding the given products (exact in f32 for tf32 operands)."""
    acc = np.zeros((a[0].shape[0], b[0].shape[1]), np.float32)
    for k in range(0, a[0].shape[1], 8):
        s = slice(k, k + 8)
        for i, j in terms:
            acc = acc + (a[i][:, s] @ b[j][s]).astype(np.float32)
    return acc


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [36, 256])
def test_3xtf32_error_within_twice_f32(seed, k):
    """lo·hi + hi·lo + hi·hi keeps 22 bits of each operand: its product
    error against float64 stays within 2× that of the f32 FMA product,
    where one TF32 pass is hundreds of times worse."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(64, k)).astype(np.float32)
    b = rng.normal(size=(k, 64)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    f32 = np.abs(_ffma(a, b) - exact).max()
    (ah, al), (bh, bl) = _split(a), _split(b)
    three = np.abs(_tiled((ah, al), (bh, bl), [(1, 0), (0, 1), (0, 0)])
                   - exact).max()
    one = np.abs(_tiled((_tf32(a),), (_tf32(b),), [(0, 0)]) - exact).max()
    assert three <= 2 * f32, (three, f32)
    assert one > 50 * f32


def test_tf32_split_is_exact_to_22_bits():
    """hi + lo equals x to within 2^-21 of |x|, and both are tf32 values."""
    x = np.random.default_rng(5).normal(size=4096).astype(np.float32)
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert err.max() <= 2.0 ** -21
