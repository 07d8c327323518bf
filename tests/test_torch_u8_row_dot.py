"""The graph beam's candidate scoring on u8 codes (``ops/kernels/u8_row_dot.py``):
its plain version against the reference's ``storage._scores_gathered`` by
cosine, dot and euclidean (live entries, -1 ids), and bit for bit against
``scores_gathered``'s u8 branch as it was before the kernel (copied below);
the CPU wrapper being the plain version; the argument checks; the profiler
group of the kernel's name; ``row_dot_bytes`` counted by hand; the beam
(``beam_search`` at both levels and visited sets, ``beam_wave_merge`` and
``beam_hostcodes_init``) with its live masks against its code before the
kernel (copied below), ids and scores bit for bit; and the kernel's parts
(``csrc/u8_row_dot.cuh``, the epilogue in ``csrc/u8_epilogue.cuh``) built for
the host by g++ over ``tests/cuda_emulation/`` and run as the launch maps
them: every score bit for bit against the plain version, each live
candidate's row read once, and no read outside the table or for a dead
entry.

Inputs come from numpy with a seed; the codes reach both ends of the int8
range, including a row and a query of -128 only (the largest sum,
2^14·Dp). Tolerance against the reference: rtol 1e-5, atol 1e-6, as
``tests/test_torch_hnsw_kernels.py:test_scores_gathered`` (XLA may fuse the
f32 epilogue into multiply-adds); everything else bit for bit."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench_torch.trace import KERNEL_GROUPS, kernel_group
from cosdata_tpu.ops import quantize as JQ
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.ops import distance as TD
from cosdata_tpu_torch.ops import hnsw_kernels as TK
from cosdata_tpu_torch.ops import storage as TS
from cosdata_tpu_torch.ops.kernels import u8_row_dot as K
from cosdata_tpu_torch.ops.quantize import quantize_u8
from cosdata_tpu_torch.ops.topk import NEG_INF, lax_top_k, unique_mask_ids
from cosdata_tpu_torch.tools.measure import row_dot_bytes

EMULATION = Path(__file__).parent / "cuda_emulation"
METRICS = ["cosine", "dot", "euclidean"]
RTOL, ATOL = 1e-5, 1e-6
#: (queries, table rows, candidates a query, Dp, every query on the same
#: rows): "wave", a level-0 wave of two row tiles (K 256) from a chunk store
#: whose rows are no multiple of 128; "upper", one tile (K 128); "ragged",
#: K 37 at Dp 1,024; "shared", every query on the same 96 rows
CASES = {"wave": (6, 3000, 256, 768, False), "upper": (5, 500, 128, 128, False),
         "ragged": (4, 300, 37, 1024, False), "shared": (7, 200, 96, 384, True)}
LIVES = ["all", "half", "none", None]


def _case(name: str, seed: int, live: str | None = "half"):
    """(q, store, ids, live, d_pad) for case ``name``: rows and queries
    quantized from seeded uniform values (true width Dp - 28), row 0 and
    query 0 of -128 only, row 1 of +127 only, row 2 query 1 itself (a
    euclidean residue that clamps), row 3 without magnitude (cosine's zero
    denominator); every query's candidates hold rows 0 to 3, and every third
    query's every seventh slot id -1. ``live``: "all", "half" (a seeded
    draw), "none" or None (no mask)."""
    b, rows, k, dp, shared = CASES[name]
    d_true = dp - 28
    rng = np.random.default_rng(seed)
    x = np.zeros((rows, dp), np.float32)
    x[:, :d_true] = rng.uniform(-1, 1, (rows, d_true)) * rng.uniform(0.5, 1.5, (rows, 1))
    qx = np.zeros((b, dp), np.float32)
    qx[:, :d_true] = rng.uniform(-1, 1, (b, d_true))
    store = quantize_u8(torch.from_numpy(x), -0.6, 0.7, d_true)
    q = quantize_u8(torch.from_numpy(qx), -0.6, 0.7, d_true)
    store.data[0] = -128
    q.data[0] = -128
    store.data[1] = 127
    store.data[2], store.sums[2], store.mags[2] = q.data[1], q.sums[1], q.mags[1]
    store.mags[3] = 0.0
    if shared:
        ids = np.tile(rng.permutation(rows)[:k], (b, 1))
    else:
        ids = rng.integers(0, rows, (b, k))
    ids[:, :4] = np.arange(4)
    ids[::3, ::7] = -1
    for row in ids:
        rng.shuffle(row)
    mask = {"all": np.ones((b, k), bool), "half": rng.random((b, k)) < 0.5, "none": np.zeros((b, k), bool),
            None: None}[live]
    return q, store, torch.from_numpy(ids.astype(np.int64)), None if mask is None else torch.from_numpy(mask), dp


def _old_u8_branch(metric, d, q, store, ids):
    """``storage.scores_gathered``'s u8 branch before the kernel."""
    safe = torch.clamp_min(ids, 0)
    cmags = TS.take_rows(store.mags, safe)
    cc = TD.diag_code_dot(q.data, TS.take_rows(store.data, safe))
    return TS.cos_or_dot(metric, TD.dequant_dot(q, cc, TS.take_rows(store.sums, safe), d), q.mags, cmags)


def _bits(x) -> np.ndarray:
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32).view(np.int32)


def _reference_case(seed: int):
    """test_scores_gathered's scale, where its tolerance holds (the f32
    terms of the dequantised dot stay near the result): 600 clustered unit
    rows of 64 dimensions (Dp 128) quantized over (-0.3, 0.3), 8 queries of
    70 candidates; row 0 and query 0 of -128 only, row 1 of +127 only, row
    3 without magnitude; every third query's every seventh id -1, half the
    entries live."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, 64)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)

    def rows(m):
        x = rng.standard_normal((m, 64)).astype(np.float32) * np.float32(0.5 / 8) + centers[rng.integers(0, 16, m)]
        return np.pad(x / np.linalg.norm(x, axis=1, keepdims=True), ((0, 0), (0, 64)))

    store = quantize_u8(torch.from_numpy(rows(600)), -0.3, 0.3, 64)
    q = quantize_u8(torch.from_numpy(rows(8)), -0.3, 0.3, 64)
    store.data[0] = -128
    q.data[0] = -128
    store.data[1] = 127
    store.mags[3] = 0.0
    ids = rng.integers(0, 600, (8, 70))
    ids[:, :4] = np.arange(4)
    ids[::3, ::7] = -1
    return q, store, torch.from_numpy(ids), torch.from_numpy(rng.random((8, 70)) < 0.5), 128


@pytest.mark.parametrize("metric", METRICS)
def test_plain_equals_the_reference(metric):
    """Live entries against the reference's _scores_gathered at the
    tolerance above; dead entries NEG_INF."""
    q, store, ids, live, dp = _reference_case(seed=1 + METRICS.index(metric))
    got = K.row_scores_plain(metric, dp, q, store, ids, live).numpy()
    jq = JQ.QuantizedU8(**{f: jnp.asarray(v.numpy()) for f, v in q._asdict().items()})
    js = JQ.QuantizedU8(**{f: jnp.asarray(v.numpy()) for f, v in store._asdict().items()})
    want = np.asarray(JS._scores_gathered(metric, "u8", dp, jq, js, jnp.asarray(ids.numpy())))
    lv = live.numpy()
    np.testing.assert_allclose(got[lv], want[lv], rtol=RTOL, atol=ATOL)
    assert (got[~lv] == NEG_INF).all() and lv.any() and (~lv).any()
    assert (ids.numpy()[lv] < 0).any()  # -1 ids among the live entries: row 0's score


@pytest.mark.parametrize("live", LIVES)
@pytest.mark.parametrize("metric", METRICS)
def test_plain_equals_the_old_branch_bit_for_bit(metric, live):
    q, store, ids, mask, dp = _case("wave", seed=7, live=live)
    got = K.row_scores_plain(metric, dp, q, store, ids, mask)
    old = _old_u8_branch(metric, dp, q, store, ids)
    want = old if mask is None else torch.where(mask, old, NEG_INF)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the largest sum, 2^14 Dp, is among the dots: query 0 with row 0
    assert 128 * 128 * dp in TD.diag_code_dot(q.data[:1], store.data[None, :1])[0].tolist()


def test_cpu_wrapper_is_the_plain_version():
    """For CPU tensors the wrapper and scores_gathered's u8 branch are the
    plain version, and launch nothing."""
    q, store, ids, live, dp = _case("upper", seed=3)
    before = K.u8_row_dot.launches
    want = K.row_scores_plain("cosine", dp, q, store, ids, live)
    for got in (K.u8_row_dot("cosine", dp, q, store, ids, live), TS.scores_gathered("cosine", "u8", dp, q, store,
                                                                                      ids, live)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(TS.scores_gathered("dot", "u8", dp, q, store, ids)),
                                  _bits(K.row_scores_plain("dot", dp, q, store, ids)))
    assert K.u8_row_dot.launches == before
    assert K.u8_row_dot("dot", dp, q, store, ids[:, :0], live[:, :0]).shape == (ids.shape[0], 0)


def test_kernel_arguments_are_checked():
    """What the launch would refuse, the wrapper refuses first (checked on
    CPU tensors: the checks read shapes, types and layout only)."""
    q, store, ids, live, dp = _case("upper", seed=4)
    args = ("cosine", dp, q, store, ids, live)
    K._check_cuda_args(*args)
    K._check_cuda_args("euclidean", dp, q, store, ids, None)

    def with_(**kw):
        named = dict(zip(("metric", "d_pad", "q", "store", "ids", "live"), args))
        named.update(kw)
        return tuple(named.values())

    bad = [
        with_(metric="hamming"),
        with_(d_pad=K.KERNEL_DP_MAX + 1),
        with_(d_pad=-1),
        with_(q=q._replace(data=q.data[:, :64].contiguous()),
              store=store._replace(data=store.data[:, :64].contiguous())),  # Dp 64
        with_(q=q._replace(data=q.data.to(torch.int16))),
        with_(q=q._replace(sums=q.sums[:2])),
        with_(q=q._replace(a=q.a[None])),
        with_(store=store._replace(sums=store.sums.to(torch.int64))),
        with_(store=store._replace(mags=store.mags[:-1])),
        with_(store=store._replace(data=store.data.t().contiguous().t())),  # not contiguous
        with_(ids=ids.to(torch.int32)),
        with_(ids=ids[:3]),  # ids for another batch
        with_(ids=ids[:, ::2]),  # not contiguous
        with_(live=live.to(torch.uint8)),
        with_(live=live[:, :5]),
    ]
    for b in bad:
        with pytest.raises(ValueError):
            K._check_cuda_args(*b)
    assert 128 * 128 * K.KERNEL_DP_MAX < 2**31 <= 128 * 128 * (K.KERNEL_DP_MAX + K.KERNEL_DP_MULTIPLE)


def test_kernel_time_lands_in_products():
    """The benchmark's profiler groups count the kernel (its name keeps
    "dot_kernel") as a product."""
    products = next(label for key, label, _ in KERNEL_GROUPS if key == "products_ms")
    assert kernel_group("(anonymous namespace)::u8_row_dot_kernel(u8_row_dot::Args)") == products
    assert kernel_group("u8_row_dot_kernel") == products
    assert "u8_row_dot_kernel" in Path(K.LIBRARY.source).read_text()


def test_row_dot_bytes_counted_by_hand():
    """2 queries x 3 candidates at Dp 128, 4 live on 3 distinct rows (5 is
    live twice): rows 3 x (128 + 4 + 4) (each candidate its own: 4 x 136),
    ids 6 x 8, live 6 x 1, queries 2 x (128 + 4 + 4), scores 6 x 4; without
    a mask every candidate is read (-1 is row 0, 5 comes twice: 4 distinct
    rows of 6 candidates) and no mask byte."""
    ids = torch.tensor([[0, 5, -1], [5, 9, 2]])
    live = torch.tensor([[True, True, False], [True, False, True]])
    assert row_dot_bytes(ids, live, 128) == (3 * 136 + 48 + 6 + 2 * 136 + 24, 4 * 136 + 48 + 6 + 2 * 136 + 24)
    assert row_dot_bytes(ids, live, 128) == (758, 894)
    assert row_dot_bytes(ids, None, 128) == (4 * 136 + 48 + 2 * 136 + 24, 6 * 136 + 48 + 2 * 136 + 24)


# ---------------------------------------------------------------- the beam before the kernel


def _init_beam_before(metric, kind, d, ef, vcap, q, store, start_ids, bitmask_w=0):
    b, s = start_ids.shape
    uniq = unique_mask_ids(start_ids)
    scores = _old_u8_branch(metric, d, q, store, start_ids)
    scores = torch.where(uniq, scores, NEG_INF)
    if bitmask_w:
        visited = torch.zeros((b, bitmask_w), dtype=torch.int32)
        _, word, bitv = TK._probe_bits(visited, start_ids)
        TK._mark_bits(visited, word, bitv, uniq & (start_ids >= 0))
    else:
        visited = torch.full((b, vcap), -1, dtype=torch.int64)
    if s < ef:
        scores = torch.nn.functional.pad(scores, (0, ef - s), value=NEG_INF)
        start_ids = torch.nn.functional.pad(start_ids, (0, ef - s), value=-1)
    top_scores, pos = lax_top_k(scores, ef)
    top_ids = torch.gather(start_ids, 1, pos)
    top_ids = torch.where(top_scores > NEG_INF / 2, top_ids, -1)
    return top_ids, top_scores, top_ids < 0, visited


def _beam_search_before(metric, kind, d, ef, expand, vcap, max_iters, q, store, adj_table, row_of, start_ids,
                        use_row_of=True, visited_impl="bitmask"):
    """``hnsw_kernels.beam_search`` before the kernel, its u8 scoring the
    old branch masked after it."""
    expand = min(expand, ef)
    max_iters = max(max_iters, 2 * -(-ef // expand))
    m = adj_table.shape[1]
    k = expand * m
    vcap = max(vcap // k, 1) * k
    bitmask_w = -(-row_of.shape[0] // 32) if visited_impl == "bitmask" else 0
    ids, scores, expanded, visited = _init_beam_before(metric, kind, d, ef, vcap, q, store, start_ids, bitmask_w)
    b = ids.shape[0]
    for t in range(max_iters):
        if t % TK.FRONTIER_CHECK == 0 and not bool(((~expanded) & (ids >= 0)).any()):
            break
        sel_scores = torch.where(expanded | (ids < 0), NEG_INF, scores)
        sel_vals, sel_pos = lax_top_k(sel_scores, expand)
        expanded = expanded.scatter(1, sel_pos, True)
        exp_ids = torch.where(sel_vals > NEG_INF / 2, torch.gather(ids, 1, sel_pos), -1)
        if use_row_of:
            rows = torch.where(exp_ids >= 0, TS.take_rows(row_of, torch.clamp_min(exp_ids, 0)).long(), -1)
        else:
            rows = exp_ids
        nbrs = TS.take_rows(adj_table, torch.clamp_min(rows, 0)).long()
        nbrs = torch.where(rows[:, :, None] >= 0, nbrs, -1).reshape(b, k)
        uniq = unique_mask_ids(nbrs)
        if bitmask_w:
            seen, word, bitv = TK._probe_bits(visited, nbrs)
            fresh = uniq & ~seen & (nbrs >= 0)
            TK._mark_bits(visited, word, bitv, fresh)
        else:
            in_beam = (nbrs[:, :, None] == ids[:, None, :]).any(-1)
            in_vis = (nbrs[:, :, None] == visited[:, None, :]).any(-1)
            fresh = uniq & ~in_beam & ~in_vis & (nbrs >= 0)
        nscores = torch.where(fresh, _old_u8_branch(metric, d, q, store, nbrs), NEG_INF)
        nids = torch.where(fresh, nbrs, -1)
        if not bitmask_w:
            pos = (t * k) % vcap
            visited[:, pos : pos + k] = nids
        all_scores = torch.cat([scores, nscores], dim=1)
        all_ids = torch.cat([ids, nids], dim=1)
        all_exp = torch.cat([expanded, torch.zeros_like(fresh)], dim=1)
        scores, pos2 = lax_top_k(all_scores, ef)
        ids = torch.gather(all_ids, 1, pos2)
        expanded = torch.gather(all_exp, 1, pos2) | (ids < 0)
    return ids, scores


def _graph(rows: int, m: int, seed: int):
    """A random level-0 adjacency (rows, m) int32 with ragged rows, and an
    upper level over every 8th row addressed by slots."""
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, rows, (rows, m)).astype(np.int32)
    adj[rng.integers(0, rows, rows // 10), m - 3 :] = -1
    members = np.arange(0, rows, 8)
    slot = np.full(rows, -1, np.int32)
    slot[members] = np.arange(len(members))
    up = members[rng.integers(0, len(members), (len(members), m // 2))].astype(np.int32)
    return torch.from_numpy(adj), torch.from_numpy(up), torch.from_numpy(slot)


@pytest.mark.parametrize("impl", ["bitmask", "ring"])
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("metric", METRICS)
def test_beam_search_equals_the_beam_before(metric, level, impl):
    q, store, _, _, dp = _case("upper", seed=11)
    rows = store.data.shape[0]
    adj, up, slot = _graph(rows, 16, seed=12)
    b = q.data.shape[0]
    if level == 0:
        table, row_of, use, ef, expand = adj, torch.arange(rows, dtype=torch.int32), False, 32, 4
        start = torch.full((b, 1), 7, dtype=torch.int64)
    else:
        table, row_of, use, ef, expand = up, slot, True, 8, 2
        start = torch.tensor([[0, 8, -1, 8]] * b, dtype=torch.int64)  # a -1 and a repeated start id
    args = (metric, "u8", dp, ef, expand, 256, 30, q, store, table, row_of, start)
    got = TK.beam_search(*args, use_row_of=use, visited_impl=impl)
    want = _beam_search_before(*args, use_row_of=use, visited_impl=impl)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))
    assert (got[0] >= 0).all()


@pytest.mark.parametrize("metric", METRICS)
def test_hostcodes_beam_equals_the_beam_before(metric):
    """beam_hostcodes_init and beam_wave_merge with their live masks against
    their code before the kernel: the start ids (a -1, a repeat) and a wave
    scored from a chunk of uploaded rows (-1 slots where none)."""
    q, store, _, _, dp = _case("upper", seed=13)
    b, rows = q.data.shape[0], store.data.shape[0]
    rng = np.random.default_rng(14)
    start = torch.from_numpy(rng.integers(0, rows, (b, 9)))
    start[:, 0] = 7
    start[2, 4], start[3, 5] = -1, start[3, 1]
    uniq_rows = torch.unique(start[start >= 0])
    chunk = store._replace(data=store.data[uniq_rows], sums=store.sums[uniq_rows], mags=store.mags[uniq_rows])
    slots = torch.where(start >= 0, torch.searchsorted(uniq_rows, torch.clamp_min(start, 0)), -1)
    w = -(-rows // 32)
    got = TK.beam_hostcodes_init(metric, dp, 16, w, q, chunk, slots, start)
    uniq = unique_mask_ids(start)
    sc = torch.where(uniq & (slots >= 0), _old_u8_branch(metric, dp, q, chunk, torch.clamp_min(slots, 0)), NEG_INF)
    sc = torch.nn.functional.pad(sc, (0, 7), value=NEG_INF)
    top_scores, pos = lax_top_k(sc, 16)
    want_ids = torch.where(top_scores > NEG_INF / 2, torch.gather(torch.nn.functional.pad(start, (0, 7), value=-1),
                                                                  1, pos), -1)
    np.testing.assert_array_equal(got[0].numpy(), want_ids.numpy())
    np.testing.assert_array_equal(_bits(got[1]), _bits(top_scores))
    ids, scores, expanded = got[:3]
    nbrs = torch.from_numpy(rng.integers(-1, rows, (b, 40)))
    slots = torch.where(nbrs >= 0, torch.from_numpy(rng.integers(0, len(uniq_rows), (b, 40))), -1)
    slots[0, :5] = -1
    new = TK.beam_wave_merge(metric, dp, q, chunk, slots, nbrs, ids, scores, expanded)
    nscores = torch.where(slots >= 0, _old_u8_branch(metric, dp, q, chunk, torch.clamp_min(slots, 0)), NEG_INF)
    old = TK._merge_beam(ids, scores, expanded, torch.where(slots >= 0, nbrs, -1), nscores)
    np.testing.assert_array_equal(new[0].numpy(), old[0].numpy())
    np.testing.assert_array_equal(_bits(new[1]), _bits(old[1]))
    np.testing.assert_array_equal(new[2].numpy(), old[2].numpy())


# ---------------------------------------------------------------- the kernel's parts on the host


@pytest.fixture(scope="module")
def kernel_host(tmp_path_factory):
    """The kernel's host-buildable parts (csrc/u8_row_dot.cuh) built for
    the host; returns a function that runs the launch's CTAs and gives the
    scores and each table row's 16-byte loads, after checking the run's
    exit code against ``rc`` (3: a read outside the table, 4: the kernel's
    __trap())."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernel's parts for the host")
    tmp = tmp_path_factory.mktemp("u8_row_dot_host")
    exe = tmp / "u8_row_dot_host"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-ffp-contract=off",
                            f"-I{EMULATION}", f"-I{Path(K.LIBRARY.source).parent}", "-o", str(exe),
                            str(EMULATION / "u8_row_dot_host.cpp")], capture_output=True, text=True)
    assert built.returncode == 0, built.stderr

    def run(metric, d_pad, q, store, ids, live, fill: int, rc: int = 0):
        b, k = ids.shape
        rows = store.data.shape[0]
        path = tmp / f"in-{fill}.bin"
        with open(path, "wb") as f:
            np.array([b, k, rows, q.data.shape[1], d_pad, K.METRIC_CODES[metric], live is not None],
                     np.int64).tofile(f)
            for x in (q.data, q.sums, q.mags, torch.stack([q.a, q.b, q.dtrue]), store.data, store.sums, store.mags,
                      ids, *(() if live is None else (live.to(torch.uint8),))):
                np.ascontiguousarray(x.numpy()).tofile(f)
        res = subprocess.run([str(exe), str(path), str(tmp / "out.bin"), str(tmp / "reads.bin"), str(fill)],
                             timeout=300)
        assert res.returncode == rc, f"the host run stopped with {res.returncode}, want {rc}"
        if rc:
            return None
        return np.fromfile(tmp / "out.bin", np.float32).reshape(b, k), np.fromfile(tmp / "reads.bin", np.int32)

    return run


def _want_reads(ids, live, rows: int, dp: int) -> np.ndarray:
    """Each live candidate's row (row 0 for a negative id) read once, in
    Dp / 16 loads; nothing else."""
    ids = ids.numpy()
    lv = np.ones(ids.shape, bool) if live is None else live.numpy()
    return np.bincount(np.clip(ids[lv & (ids < rows)], 0, None), minlength=rows).astype(np.int32) * (dp // 16)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_host_kernel_equals_plain_bit_for_bit(kernel_host, name, metric):
    """The kernel's query copy, partials, shuffles and epilogue run as the
    launch maps them (the query's shared buffer first filled with a byte
    pattern, so a read of a byte no copy brought would show): every score
    bit for bit against the plain version, each live candidate's row read
    once, no dead entry's."""
    q, store, ids, live, dp = _case(name, seed=10 * len(name) + METRICS.index(metric))
    want = K.row_scores_plain(metric, dp, q, store, ids, live).numpy()
    got, reads = kernel_host(metric, dp, q, store, ids, live, fill=0x5A if metric == "dot" else -128)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(reads, _want_reads(ids, live, store.data.shape[0], dp))
    assert (want == NEG_INF).any() and (want > NEG_INF).any()


@pytest.mark.parametrize("live", ["all", "none", None])
def test_host_kernel_live_masks(kernel_host, live):
    """All live, none live (no row read at all, every score NEG_INF) and no
    mask."""
    q, store, ids, mask, dp = _case("wave", seed=21, live=live)
    want = K.row_scores_plain("euclidean", dp, q, store, ids, mask).numpy()
    got, reads = kernel_host("euclidean", dp, q, store, ids, mask, fill=0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(reads, _want_reads(ids, mask, store.data.shape[0], dp))
    assert (reads.sum() == 0) == (live == "none")


def test_host_kernel_reads_nothing_outside_the_table(kernel_host):
    """A live entry's id at or past the table's rows stops the launch (the
    kernel's __trap(): exit 4) before any read outside the table (exit 3),
    as the plain version raises on it. A dead entry's id is not read: past
    the table it scores NEG_INF, and every other score is the plain
    version's."""
    q, store, ids, live, dp = _case("ragged", seed=5, live="all")
    rows = store.data.shape[0]
    for outside in ((0, 3), (2, 0)):
        bad = ids.clone()
        bad[outside] = rows if outside[0] != 2 else rows + 10**9
        with pytest.raises(IndexError):
            K.row_scores_plain("cosine", dp, q, store, bad, live)
        assert kernel_host("cosine", dp, q, store, bad, live, fill=0, rc=4) is None
    bad, mask = ids.clone(), live.clone()
    bad[1, 5], mask[1, 5] = rows + 10**9, False
    want = K.row_scores_plain("cosine", dp, q, store, ids, mask).numpy()
    got, reads = kernel_host("cosine", dp, q, store, bad, mask, fill=0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[1, 5] == NEG_INF
    np.testing.assert_array_equal(reads, _want_reads(ids, mask, rows, dp))
