"""CLI entry point:
``python -m cosdata_tpu_torch --admin-key KEY [--device cuda] [--config path]``.

Mirrors upstream src/main.rs:29-53 + src/args.rs:5-15.

Port of ``cosdata_tpu/__main__.py``. ``--device`` (``cuda``, ``cuda:N`` or
``cpu``) defaults to ``cuda``: the server runs on the card unless asked for
the CPU with ``--device cpu``, and refuses ``cuda`` when torch sees no card
(it never moves to the CPU on its own). On a CUDA device the exact-scan
dense searches run the hand-written kernels and the HNSW graph runs as
torch operations on the card. The reference's device warm-up is not
ported.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def main():
    parser = argparse.ArgumentParser("cosdata_tpu_torch")
    parser.add_argument(
        "--device", default="cuda", help="torch device of every index: cuda (the default), cuda:N or cpu"
    )
    parser.add_argument("--admin-key", required=True, help="admin key (required)")
    parser.add_argument("--config", default="config.toml", help="TOML config path")
    parser.add_argument("--data-path", default=None, help="override data path")
    parser.add_argument(
        "--skip-confirmation", action="store_true", help="accepted for CLI parity"
    )
    parser.add_argument("--no-grpc", action="store_true", help="disable gRPC server")
    args = parser.parse_args()

    import torch

    try:
        device = torch.device(args.device)
    except RuntimeError:
        device = None
    if device is None or device.type not in ("cuda", "cpu"):
        parser.error(f"--device must be cuda, cuda:N or cpu, not {args.device!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: torch sees no CUDA device")

    logging.basicConfig(level=logging.INFO)

    from cosdata_tpu_torch.config import load_config

    overrides = {}
    if args.data_path:
        overrides["data_path"] = args.data_path
    # the default "config.toml" is optional (pure defaults when absent);
    # an EXPLICIT --config that doesn't exist fails fast in load_config
    cfg_path = args.config
    if cfg_path == "config.toml" and not Path(cfg_path).exists():
        cfg_path = None
    config = load_config(cfg_path, **overrides)
    import os

    if os.environ.get("COSDATA_HOST"):
        config.server.host = os.environ["COSDATA_HOST"]
        config.grpc.host = os.environ["COSDATA_HOST"]

    from cosdata_tpu_torch.core.app_context import AppContext
    from cosdata_tpu_torch.api.server import run_server

    ctx = AppContext(config, admin_key=args.admin_key, device=device)

    # spawn the gRPC server next to HTTP (main.rs:40-47 + grpc/server.rs:24-44)
    if not args.no_grpc:
        try:
            from cosdata_tpu_torch.grpc_api.server import build_server

            grpc_server = build_server(ctx)
            grpc_server.start()
            logging.info(
                "gRPC server on %s:%s", config.grpc.host, config.grpc.port
            )
        except Exception:
            logging.exception("gRPC server failed to start; continuing with HTTP")

    run_server(ctx)


if __name__ == "__main__":
    main()
