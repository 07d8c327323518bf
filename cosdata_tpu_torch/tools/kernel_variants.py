"""Time variants of the port's CUDA kernels on the card: what part of a
kernel's time a piece of it costs.

A variant is a copy of ``cosdata_tpu_torch/csrc`` with string edits; each
is built by the package's ``CudaLibrary`` (in parallel) beside its copy in
a scratch directory, swapped into the wrapper in place of the package's library,
checked against the plain version (a timing-only variant is not exact and
says so) and timed at the main path's shapes: K1 at B=1024 and 128, C =
1,048,576, Dp=768, cosine; K2 at res=2, B=1024 and 128, C=65,536, Dp=768,
its raw int32 entry and its fused entry by dot and by cosine (a mask of
every row; the fused scores held bit for bit). Needs one CUDA card and
nvcc; run from the repository root:

    python3 -m cosdata_tpu_torch.tools.kernel_variants [variant ...]   # default: all

Variants:
  k1, k2          the package's kernels as they are
  k1_no_epilogue  K1 without the epilogue's arithmetic (timing only)
  k1_bitcast_i2f  K1 with the int -> float conversion a bit cast (timing only)
  k2_fdiv         K2's fused cosine dividing by __fdiv_rn (exact, with its
                  slow-path call) in place of the branch-free div_rn
"""

from __future__ import annotations

import concurrent.futures
import shutil
import sys
import tempfile
from pathlib import Path

import torch

from cosdata_tpu_torch.ops.kernels import nvcc, subbyte_scan, u8_scan
from cosdata_tpu_torch.ops.quantize import quantize_subbyte, quantize_u8
from cosdata_tpu_torch.tools.measure import card_line, device_ms

CSRC = Path(nvcc.__file__).resolve().parents[2] / "csrc"
K1, K2 = "u8_bin_max", "subbyte_code_scores"
VARIANTS = {
    "k1": (K1, []),
    "k2": (K2, []),
    "k1_no_epilogue": (K1, [("if (bin0 + bn >= n_bins) continue;", "if (B > 0) continue;")]),
    "k1_bitcast_i2f": (K1, [("__fmul_rn(a2, __int2float_rn(cc))", "__fmul_rn(a2, __int_as_float(cc))")]),
    "k2_fdiv": (K2, [("div_rn(dot, den) : 0.f", "__fdiv_rn(dot, den) : 0.f")]),
}


def build(name: str, root: Path) -> tuple[str, nvcc.CudaLibrary, str]:
    """Copy csrc with the variant's edits and build it beside the copy."""
    kernel, edits = VARIANTS[name]
    src = root / name
    shutil.copytree(CSRC, src)
    cu = src / f"{kernel}.cu"
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"FAIL: variant {name}: {old!r} is not in {cu.name}")
        text = text.replace(old, new)
    cu.write_text(text)
    module = u8_scan if kernel == K1 else subbyte_scan
    lib = nvcc.CudaLibrary(kernel, module.LIBRARY.entries, source=cu, library=src / f"lib{kernel}.so")
    return name, lib, lib.build()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: the variants run on a CUDA card")
    names = sys.argv[1:] or list(VARIANTS)
    dev = torch.device("cuda")
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((1_048_576, 768), generator=gen, device=dev) * 2 - 1
    store = quantize_u8(x, -0.6, 0.7, 768)
    sub = quantize_subbyte(x[:65_536], 2, 768)
    planes = sub.planes
    del x
    valid = torch.ones(store.data.shape[0], dtype=torch.bool, device=dev)
    valid[-1000:] = False
    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        for name, lib, log in ex.map(lambda n: build(n, Path(tmp)), names):
            kernel = VARIANTS[name][0]
            module = u8_scan if kernel == K1 else subbyte_scan
            package_lib, module.LIBRARY = module.LIBRARY, lib  # the wrapper launches the variant
            try:
                regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
                print(f"== {name} [{card}]: " + "; ".join(regs[:2]), flush=True)
                for b in (1024, 128):
                    if kernel == K1:
                        q = quantize_u8(torch.rand((b, 768), generator=gen, device=dev) * 2 - 1, -0.6, 0.7, 768)
                        t = u8_scan.bin_max_terms("cosine", q, store, valid, 768)
                        run = lambda: u8_scan.u8_bin_max("cosine", 32, t)  # noqa: E731
                        err = float((run() - u8_scan.u8_bin_max_plain("cosine", 32, t)).abs().max())
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
