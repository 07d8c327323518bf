"""K1 and K2 of one checkout of the port, timed two ways at the main path's
shapes, so that two commits can be compared on one card.

Imports ``cosdata_tpu_torch`` from TREE (default: the checkout this file is
in), which builds its kernels from TREE's sources, checks each kernel
against its plain version and times the wrapper call two ways:

- ``single``: the median of 5 calls, each timed alone by CUDA events
  (``chip_smoke.py``'s ``ms``), so a call's host time shows where the
  card waits for it;
- ``back_to_back``: the mean of 20 calls queued behind a spin kernel, so
  host time between calls is hidden.

``torch._int_mm`` on the same int8 codes (the product only) is timed both
ways beside each. Shapes: K1 at B=1024 and 128, C=1,048,576, Dp=768,
cosine; K2 at res=2, B=1024, C=65,536, Dp=768; inputs from seed 0. Prints
one JSON line. Needs one CUDA card. Run it as a script, once per checkout,
each in its own process (for two commits: parent, change, change, parent):

    python3 cosdata_tpu_torch/tools/kernel_times.py [TREE]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def main() -> None:
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(tree))  # before the first import of the package
    import torch

    from cosdata_tpu_torch.ops.kernels import subbyte_scan, u8_scan
    from cosdata_tpu_torch.ops.quantize import quantize_subbyte, quantize_u8, subbyte_values
    from measure import card_line, cuda_ms, device_ms  # this file's sibling, run as a script

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: kernel_times needs a CUDA card")
    if Path(u8_scan.__file__).resolve().parents[3] != tree:
        raise SystemExit(f"FAIL: cosdata_tpu_torch came from {u8_scan.__file__}, not {tree}")
    dev = torch.device("cuda")
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((1_048_576, 768), generator=gen, device=dev) * 2 - 1
    store = quantize_u8(x, -0.6, 0.7, 768)
    planes = quantize_subbyte(x[:65_536], 2, 768).planes
    del x
    valid = torch.ones(store.data.shape[0], dtype=torch.bool, device=dev)
    valid[-1000:] = False

    def timed(run, plain, library) -> dict:
        got, want = run(), plain()
        live = want > -1e37 if want.dtype == torch.float32 else torch.ones_like(want, dtype=torch.bool)
        err = float((got[live].double() - want[live].double()).abs().max())
        return {"max_abs_err": err, "single": cuda_ms(run, 5), "back_to_back": device_ms(run, 20),
                "library_single": cuda_ms(library, 5), "library_back_to_back": device_ms(library, 20)}

    out = {"tree": str(tree), "card": card}
    for b in (1024, 128):
        q = quantize_u8(torch.rand((b, 768), generator=gen, device=dev) * 2 - 1, -0.6, 0.7, 768)
        t = u8_scan.bin_max_terms("cosine", q, store, valid, 768)
        out[f"k1_b{b}"] = timed(lambda: u8_scan.u8_bin_max("cosine", 32, t),
                                lambda: u8_scan.u8_bin_max_plain("cosine", 32, t),
                                lambda: torch._int_mm(t.q_codes, t.codes.t()))
    qp = quantize_subbyte(torch.rand((1024, 768), generator=gen, device=dev) * 2 - 1, 2, 768).planes
    qc, vc = (subbyte_values(p, 768).to(torch.int8).contiguous() for p in (qp, planes))
    out["k2_b1024"] = timed(lambda: subbyte_scan.subbyte_code_scores(qp, planes, 768),
                            lambda: subbyte_scan.subbyte_code_scores_plain(qp, planes, 768),
                            lambda: torch._int_mm(qc, vc.t()))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
