"""Time variants of the port's CUDA kernels on the card: what part of a
kernel's time a piece of it costs.

A variant is a copy of ``cosdata_tpu_torch/csrc`` with string edits; each
is built by the package's ``CudaLibrary`` (in parallel) beside its copy in
a scratch directory, swapped into the wrapper in place of the package's library,
checked against the plain version (a timing-only variant is not exact and
says so) and timed at the main path's shapes: K1 at B=1024 and 128, C =
1,048,576, Dp=768, by cosine, dot and euclidean, its bins held bit for
bit; K2 at res=2, B=1024 and 128, C=65,536, Dp=768,
its raw int32 entry and its fused entry by dot and by cosine (a mask of
every row; the fused scores held bit for bit); group_topk at B=1024,
C=65,536, k=200 on the first and the last merge of a quaternary cosine
scan of 1,000,000 clustered rows (``measure.quaternary_scan_merges``),
its sorted values held bit for bit against its plain version;
u8_block_dot (stage 4: the sort and the kernel) by cosine at B=1024, 64
blocks of 32 rows a query, Dp=768, on random blocks of the 1M table, on a
65,536-row chunk (50 blocks a query) and on the bins K1 picks for 1,024
clustered queries, its scores held bit for bit, beside the sort alone.
Needs one
CUDA card and nvcc; each variant's SASS is counted by opcode where
cuobjdump is found. Run from the repository root:

    python3 -m cosdata_tpu_torch.tools.kernel_variants [variant ...]   # default: all

Variants:
  k1, k2          the package's kernels as they are
  k1_no_epilogue  K1 without the epilogue's arithmetic (timing only)
  k1_bitcast_i2f  K1 with cosine's and dot's int -> float conversion a bit
                  cast (timing only)
  k1_e_fsub       euclidean's d2 as the reference writes it, a doubling
                  and a subtraction, not one fused multiply-add
  k2_fdiv         K2's fused cosine dividing by __fdiv_rn (exact, with its
                  slow-path call) in place of the branch-free div_rn
  gt              group_topk as it is
  gt_slack256     a survivor buffer of k + 256 entries, not k + 512
  gt_no_drop      at most 256 survivors held in registers always take the
                  select, never the rounds that drop the smallest
  gt_buffer       every row within the buffer selects over the buffer: no
                  survivors held in registers
  gt_trace        group_topk timing each row's warp in four phases (the
                  global timer) into an output of its own (timing only)
  bd              u8_block_dot as it is (windows of 16 entries, 2 stages,
                  slices of 256 bytes)
  bd_w32, bd_w64  windows of 32 or 64 sorted entries a CTA
  bd_st3          3 stages in the ring
  bd_s128         slices of 128 bytes (one TMA box a step)
  bd_no_products  the walk and its copies without the products and the
                  epilogue (timing only)
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from cosdata_tpu_torch.ops.kernels import group_topk, nvcc, subbyte_scan, u8_block_dot, u8_scan
from cosdata_tpu_torch.ops.quantize import quantize_subbyte, quantize_u8
from cosdata_tpu_torch.tools.measure import card_line, clustered, device_ms, quaternary_scan_merges

CSRC = Path(nvcc.__file__).resolve().parents[2] / "csrc"
K1, K2, GT, BD = "u8_bin_max", "subbyte_code_scores", "group_topk", "u8_block_dot"
MODULES = {K1: u8_scan, K2: subbyte_scan, GT: group_topk, BD: u8_block_dot}
VARIANTS = {
    "k1": (K1, []),
    "k2": (K2, []),
    "k1_no_epilogue": (K1, [("  const uint32_t t0 = x.terms + 4 * (r.tb * 3 * kBN + half * kHalf);",
                             "  if (x.B > 0) return;\n  const uint32_t t0 = x.terms + 4 * (r.tb * 3 * kBN + half * kHalf);")]),
    "k1_bitcast_i2f": (K1, [("__fmul_rn(a2, __int2float_rn(cc))", "__fmul_rn(a2, __int_as_float(cc))")]),
    "k1_e_fsub": (K1, [("u8_euclidean.cuh", "__fmaf_rn(-2.0f, dot, __fadd_rn(q_sq, v_sq))",
                        "__fsub_rn(__fadd_rn(q_sq, v_sq), __fadd_rn(dot, dot))")]),
    "k2_fdiv": (K2, [("div_rn(dot, den) : 0.f", "__fdiv_rn(dot, den) : 0.f")]),
    "gt": (GT, []),
    "gt_slack256": (GT, [("constexpr int kSlack = 512;", "constexpr int kSlack = 256;")]),
    "gt_no_drop": (GT, [("if (n - k <= 32) {", "if (false) {")]),
    "gt_buffer": (GT, [("if (n <= 8 * 32) {", "if (false) {")]),
    "bd": (BD, []),
    "bd_w32": (BD, [("u8_block_dot.cuh", "constexpr int kWindow = 16;", "constexpr int kWindow = 32;")]),
    "bd_w64": (BD, [("u8_block_dot.cuh", "constexpr int kWindow = 16;", "constexpr int kWindow = 64;")]),
    "bd_st3": (BD, [("u8_block_dot.cuh", "constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    "bd_s128": (BD, [("u8_block_dot.cuh", "constexpr int kSlice = 256;", "constexpr int kSlice = 128;")]),
    "bd_no_products": (BD, [("      slice_products(sh.rows[st], sh.queries[st], m0, n0, slice_width(a.dp, s), lane, acc);\n"
                             "      if (s == slices - 1) write_scores(", "      if (s == slices - 1 && a.dp < 0) write_scores(")]),
}
#: gt_trace adds an output, trace (B, 4) int32, the last argument of the
#: launch: each row's warp's time (the global timer, ns) in four phases: T,
#: the candidate groups, the survivors, the select and the output
_STAMP = "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"({}));\n"
TRACE = [("long long start, int cap, int* __restrict__ survivors) {",
          "long long start, int cap, int* __restrict__ survivors, int* __restrict__ trace) {"),
         ("void* survivors, void* stream) {", "void* survivors, void* stream, void* trace) {"),
         ("start, cap, static_cast<int*>(survivors));", "start, cap, static_cast<int*>(survivors), static_cast<int*>(trace));"),
         ("  // the running top and the group maxima into shared memory",
          "  unsigned long long t0, t1, t2, t3, t4;\n" + _STAMP.format("t0") +
          "  // the running top and the group maxima into shared memory"),
         ("  // the candidate groups: those reaching T", _STAMP.format("t1") + "  // the candidate groups: those reaching T"),
         ("  // the survivors: the running entries", _STAMP.format("t2") + "  // the survivors: the running entries"),
         ("  // the k best survivors", _STAMP.format("t3") + "  // the k best survivors"),
         ("start + row_of(i);\n    });\n  }\n}",
          "start + row_of(i);\n    });\n  }\n" + _STAMP.format("t4") +
          "  if (lane == 0) {\n"
          "    trace[4 * q] = static_cast<int>(t1 - t0);\n    trace[4 * q + 1] = static_cast<int>(t2 - t1);\n"
          "    trace[4 * q + 2] = static_cast<int>(t3 - t2);\n    trace[4 * q + 3] = static_cast<int>(t4 - t3);\n  }\n}")]
VARIANTS["gt_trace"] = (GT, TRACE)


def build(name: str, root: Path) -> tuple[str, nvcc.CudaLibrary, str]:
    """Copy csrc with the variant's edits and build it beside the copy."""
    kernel, edits = VARIANTS[name]
    src = root / name
    shutil.copytree(CSRC, src)
    cu = src / f"{kernel}.cu"
    for edit in edits:  # (old, new) edits the kernel's source, (file, old, new) a header beside it
        path, old, new = (cu, *edit) if len(edit) == 2 else (src / edit[0], *edit[1:])
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"FAIL: variant {name}: {old!r} is not in {path.name}")
        path.write_text(text.replace(old, new))
    entries = MODULES[kernel].LIBRARY.entries
    if name == "gt_trace":
        entries = {"launch": [*entries["launch"], ctypes.c_void_p]}
    lib = nvcc.CudaLibrary(kernel, entries, source=cu, library=src / f"lib{kernel}.so")
    return name, lib, lib.build()


#: the opcodes sass_lines counts (the rest go into the total): I2FP is the
#: int -> float conversion on the f32 pipe, I2F the one on the slow pipe,
#: LD a generic load, IGMMA the int8 warpgroup product
SASS_OPS = ("I2FP", "I2F", "IADD3", "FADD", "FMUL", "FFMA", "FMNMX", "MUFU", "LDS", "LD", "SHFL", "BRA", "CALL",
            "IGMMA", "SYNCS")


def sass_lines(lib: nvcc.CudaLibrary) -> list[str]:
    """Each kernel's instruction count in the built library, whole and by
    SASS_OPS (cuobjdump -sass; none where cuobjdump is missing)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return []
    sass = subprocess.run([tool, "-sass", str(lib.library)], capture_output=True, text=True, check=True).stdout
    lines = []
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part)
        count = collections.Counter(ops)
        lines.append(f"  sass {name[-60:]}: {len(ops)} instructions; " +
                     ", ".join(f"{op} {count[op]}" for op in SASS_OPS if count[op]))
    return lines


def trace_line(lib: nvcc.CudaLibrary, scores, gmax, top_s, top_i, start: int) -> str:
    """gt_trace's launch on one merge's inputs: its values against the
    plain version's, and the median phases of a row's warp."""
    b, k = top_s.shape
    out_s, out_i = torch.empty_like(top_s), torch.empty_like(top_i)
    trace = torch.zeros((b, 4), dtype=torch.int32, device=scores.device)
    lib.launch(scores.data_ptr(), gmax.data_ptr(), top_s.data_ptr(), top_i.data_ptr(), out_s.data_ptr(),
               out_i.data_ptr(), b, scores.shape[1], gmax.shape[1], k, start, None,
               torch.cuda.current_stream().cuda_stream, trace.data_ptr())
    want = torch.sort(group_topk.merge_group_topk_plain(scores, gmax, top_s, top_i, start)[0], dim=1).values
    same = torch.equal(torch.sort(out_s, dim=1).values.view(torch.int32), want.view(torch.int32))
    us = trace.double() / 1000
    med = [f"{float(x):.2f}" for x in us.median(0).values]
    return (f"values bit for bit {same}; a row's warp, median us: T {med[0]}, groups {med[1]}, survivors {med[2]}, "
            f"select and output {med[3]}; total {float(us.sum(1).median()):.2f}")


def block_dot_inputs(store, valid, gen, dev) -> dict:
    """Stage 4's inputs (queries, store, valid rows, bin maxima, block ids)
    at B=1024, 32-row blocks, Dp=768: 64 random distinct blocks of the 1M
    table, 50 of a 65,536-row chunk, and the 64 bins K1 picks by cosine for
    1,024 clustered queries over 1,000,000 clustered rows."""
    def random_case(st, v, k):
        q = quantize_u8(torch.rand((1024, 768), generator=gen, device=dev) * 2 - 1, -0.6, 0.7, 768)
        ids = torch.topk(torch.rand((1024, st.data.shape[0] // 32), generator=gen, device=dev), k, dim=1).indices
        bin_s = torch.sort(torch.rand((1024, k), generator=gen, device=dev), dim=1, descending=True).values
        return q, st, v, bin_s, ids

    chunk = store._replace(data=store.data[:65_536], sums=store.sums[:65_536], mags=store.mags[:65_536])
    cases = {"resident (random blocks)": random_case(store, valid, 64),
             "streamed chunk": random_case(chunk, valid[:65_536], 50)}
    xc, qc = clustered(1_000_000, 1024, 768, gen, dev)
    cstore, cq = quantize_u8(xc, -0.1, 0.1, 768), quantize_u8(qc, -0.1, 0.1, 768)
    del xc
    cvalid = torch.ones(1_000_000, dtype=torch.bool, device=dev)
    bin_s, ids = torch.topk(u8_scan.u8_bin_max_from_store("cosine", 32, cq, cstore, cvalid, 768), 64, dim=1)
    cases["clustered (K1's bins)"] = (cq, cstore, cvalid, bin_s, ids)
    return cases


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: the variants run on a CUDA card")
    names = list(dict.fromkeys(sys.argv[1:])) or list(VARIANTS)  # each variant once
    dev = torch.device("cuda")
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = {VARIANTS[name][0] for name in names}
    if kernels & {K1, K2, BD}:
        x = torch.rand((1_048_576, 768), generator=gen, device=dev) * 2 - 1
        store = quantize_u8(x, -0.6, 0.7, 768)
        sub = quantize_subbyte(x[:65_536], 2, 768)
        planes = sub.planes
        del x
        valid = torch.ones(store.data.shape[0], dtype=torch.bool, device=dev)
        valid[-1000:] = False
    if GT in kernels:  # the inputs of the scan's first and last merges, made by the package's kernels
        xc, qc = clustered(1_000_000, 1024, 768, gen, dev)
        merges = {}
        quaternary_scan_merges(xc, qc, 200, lambda i, *m: merges.update({i: m}) if i in (0, 15) else None)
        del xc, qc
    if BD in kernels:  # stage 4's inputs: random blocks of the 1M table, a chunk's, K1's bins for clustered queries
        stage4 = block_dot_inputs(store, valid, gen, dev)
    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        for name, lib, log in ex.map(lambda n: build(n, Path(tmp)), names):
            kernel = VARIANTS[name][0]
            module = MODULES[kernel]
            package_lib, module.LIBRARY = module.LIBRARY, lib  # the wrapper launches the variant
            try:
                regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
                print(f"== {name} [{card}]: " + "; ".join(regs[:2]), flush=True)
                print("\n".join(sass_lines(lib)), flush=True)
                if kernel == GT:
                    for (scores, gmax, top_s, top_i, start), where in zip(merges.values(), ("first", "last")):
                        if name == "gt_trace":
                            print(f"  {where} merge: {trace_line(lib, scores, gmax, top_s, top_i, start)}", flush=True)
                            continue
                        run = lambda: group_topk.merge_group_topk(scores, gmax, top_s, top_i, start)  # noqa: E731
                        got = torch.sort(run()[0], dim=1).values
                        want = torch.sort(group_topk.merge_group_topk_plain(scores, gmax, top_s, top_i, start)[0],
                                          dim=1).values
                        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
                        ms = [device_ms(run, 20) for _ in range(2)]
                        print(f"  {where} merge: values bit for bit {same}, {ms[0]:.4f}/{ms[1]:.4f} ms", flush=True)
                    continue
                if kernel == BD:
                    for where, (q, st, v, bin_s, ids) in stage4.items():
                        run = lambda: u8_block_dot.u8_block_dot("cosine", 768, 32, q, st, v, bin_s, ids)  # noqa: E731
                        want = u8_block_dot.block_scores_plain("cosine", 768, 32, q, st, v, bin_s, ids)
                        same = torch.equal(run().view(torch.int32), want.view(torch.int32))
                        ms = [device_ms(run, 20) for _ in range(2)]
                        sort = device_ms(lambda: u8_block_dot.invert(ids), 20)
                        print(f"  {where}: scores bit for bit {same}, {ms[0]:.4f}/{ms[1]:.4f} ms (the sort alone "
                              f"{sort:.4f})", flush=True)
                    continue
                for b in (1024, 128):
                    if kernel == K1:
                        q = quantize_u8(torch.rand((b, 768), generator=gen, device=dev) * 2 - 1, -0.6, 0.7, 768)
                        for metric in ("cosine", "dot", "euclidean"):
                            t = u8_scan.bin_max_terms(metric, q, store, valid, 768)
                            run = lambda: u8_scan.u8_bin_max(metric, 32, t)  # noqa: E731
                            same = torch.equal(run(), u8_scan.u8_bin_max_plain(metric, 32, t))
                            ms = [device_ms(run, 10) for _ in range(2)]
                            print(f"  B={b} {metric}: bins bit for bit {same}, {ms[0]:.4f}/{ms[1]:.4f} ms", flush=True)
                        continue
                    else:
                        qs = quantize_subbyte(torch.rand((b, 768), generator=gen, device=dev) * 2 - 1, 2, 768)
                        qp = qs.planes
                        run = lambda: subbyte_scan.subbyte_code_scores(qp, planes, 768)  # noqa: E731
                        err = float((run() - subbyte_scan.subbyte_code_scores_plain(qp, planes, 768)).abs().max())
                    ms = [device_ms(run, 10) for _ in range(2)]
                    print(f"  B={b}: max_abs_err {err:.3g}, {ms[0]:.4f}/{ms[1]:.4f} ms", flush=True)
                    if kernel == K2:
                        every = torch.ones(sub.planes.shape[1], dtype=torch.bool, device=dev)
                        for metric in ("dot", "cosine"):
                            run = lambda: subbyte_scan.subbyte_scores_fused(metric, qs, sub, 768, every)  # noqa: E731
                            got = run()[0]
                            want = subbyte_scan.subbyte_scores_fused_plain(metric, qs, sub, 768, every)[0]
                            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
                            ms = [device_ms(run, 10) for _ in range(2)]
                            print(f"  B={b} fused {metric}: bit for bit {same}, {ms[0]:.4f}/{ms[1]:.4f} ms", flush=True)
            finally:
                module.LIBRARY = package_lib


if __name__ == "__main__":
    main()
