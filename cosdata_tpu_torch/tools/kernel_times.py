"""K1, K2 and group_topk of one checkout of the port, timed two ways at the
main path's shapes, so that two commits can be compared on one card.

Imports ``cosdata_tpu_torch`` from TREE (default: the checkout this file is
in), which builds its kernels from TREE's sources, checks K1 and K2
against their plain versions and times each wrapper call two ways:

- ``single``: the median of 5 calls, each timed alone by CUDA events
  (``chip_smoke.py``'s ``ms``), so a call's host time shows where the
  card waits for it;
- ``back_to_back``: the mean of 20 calls queued behind a spin kernel, so
  host time between calls is hidden.

``torch._int_mm`` on the same int8 codes (the product only) is timed both
ways beside K1 and K2. Shapes: K1 at Dp=768 by cosine at B=1024 and 128,
C=1,048,576, by euclidean at B=1024, C=1,048,576, and by both at B=1024,
C=65,536, the last 1,000 rows invalid; K2 at res=2, B=1024, C=65,536, Dp=768; group_topk at B=1024,
C=65,536, k=200 on every merge of a quaternary cosine scan of 1,000,000
clustered rows (``measure.quaternary_scan_merges``: the main path's
running tops, from empty to late; back to back each, and single on the
first and the last) and their sum. Inputs from seed 0. Prints
one JSON line. Needs one CUDA card. Run it as a script, once per
checkout, each in its own process (for two commits: parent, change,
change, parent); name kernels to time only those:

    python3 cosdata_tpu_torch/tools/kernel_times.py [TREE] [k1] [k2] [group_topk]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

KERNELS = ("k1", "k2", "group_topk")
#: K1's cases: key, metric, B, C (a resident 1M scan; a 65,536-row chunk
#: of the streamed and approx scans)
K1_CASES = (("k1_b1024", "cosine", 1024, 1_048_576), ("k1_b128", "cosine", 128, 1_048_576),
            ("k1_euclidean_b1024", "euclidean", 1024, 1_048_576),
            ("k1_c65536_b1024", "cosine", 1024, 65_536), ("k1_euclidean_c65536_b1024", "euclidean", 1024, 65_536))


def main() -> None:
    args = sys.argv[1:]
    tree = Path(args.pop(0) if args and args[0] not in KERNELS else Path(__file__).resolve().parents[2]).resolve()
    kernels = args or list(KERNELS)
    if any(name not in KERNELS for name in kernels):
        raise SystemExit(f"FAIL: kernels are {KERNELS}, got {kernels}")
    sys.path.insert(0, str(tree))  # before the first import of the package
    import torch

    from cosdata_tpu_torch.ops.kernels import group_topk, subbyte_scan, u8_scan
    from cosdata_tpu_torch.ops.quantize import quantize_subbyte, quantize_u8, subbyte_values
    from measure import card_line, clustered, cuda_ms, device_ms, quaternary_scan_merges  # this file's sibling

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: kernel_times needs a CUDA card")
    if Path(u8_scan.__file__).resolve().parents[3] != tree:
        raise SystemExit(f"FAIL: cosdata_tpu_torch came from {u8_scan.__file__}, not {tree}")
    dev = torch.device("cuda")
    out = {"tree": str(tree), "card": card_line()}
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(run, plain, library) -> dict:
        got, want = run(), plain()
        live = want > -1e37 if want.dtype == torch.float32 else torch.ones_like(want, dtype=torch.bool)
        err = float((got[live].double() - want[live].double()).abs().max())
        return {"max_abs_err": err, "single": cuda_ms(run, 5), "back_to_back": device_ms(run, 20),
                "library_single": cuda_ms(library, 5), "library_back_to_back": device_ms(library, 20)}

    if "k1" in kernels or "k2" in kernels:
        x = torch.rand((1_048_576, 768), generator=gen, device=dev) * 2 - 1
        store = quantize_u8(x, -0.6, 0.7, 768)
        planes = quantize_subbyte(x[:65_536], 2, 768).planes
        del x
    if "k1" in kernels:
        for key, metric, b, c in K1_CASES:
            q = quantize_u8(torch.rand((b, 768), generator=gen, device=dev) * 2 - 1, -0.6, 0.7, 768)
            rows = store._replace(data=store.data[:c], sums=store.sums[:c], mags=store.mags[:c])
            valid = torch.arange(c, device=dev) < c - 1000  # the last 1,000 rows invalid
            t = u8_scan.bin_max_terms(metric, q, rows, valid, 768)
            out[key] = timed(lambda: u8_scan.u8_bin_max(metric, 32, t),
                             lambda: u8_scan.u8_bin_max_plain(metric, 32, t),
                             lambda: torch._int_mm(t.q_codes, t.codes.t()))
    if "k2" in kernels:
        qp = quantize_subbyte(torch.rand((1024, 768), generator=gen, device=dev) * 2 - 1, 2, 768).planes
        qc, vc = (subbyte_values(p, 768).to(torch.int8).contiguous() for p in (qp, planes))
        out["k2_b1024"] = timed(lambda: subbyte_scan.subbyte_code_scores(qp, planes, 768),
                                lambda: subbyte_scan.subbyte_code_scores_plain(qp, planes, 768),
                                lambda: torch._int_mm(qc, vc.t()))
    if "group_topk" in kernels:
        x, q = clustered(1_000_000, 1024, 768, torch.Generator(device=dev).manual_seed(0), dev)
        every = []

        def visit(i, scores, gmax, top_s, top_i, start):
            run = lambda: group_topk.merge_group_topk(scores, gmax, top_s, top_i, start)  # noqa: E731
            every.append(device_ms(run, 20))
            if i in (0, 15):
                out[f"group_topk_chunk{i}"] = {"single": cuda_ms(run, 5), "back_to_back": every[-1]}

        quaternary_scan_merges(x, q, 200, visit)
        out["group_topk_every_chunk_back_to_back"] = every
        out["group_topk_scan_back_to_back_sum"] = sum(every)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
