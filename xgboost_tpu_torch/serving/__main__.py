"""Entry point: ``python -m xgboost_tpu_torch.serving --model m.bin
--port 8080 [--device cpu]``.

Flag names map one to one onto the classic CLI's ``task=serve``
parameters (``serve_port=...`` -> ``--port``); both surfaces come from
``xgboost_tpu_torch.config.SERVE_PARAMS``.  ``--device`` is ``cuda``
(the default; raises without a GPU) or ``cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from xgboost_tpu_torch.config import SERVE_PARAMS


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m xgboost_tpu_torch.serving",
        description="Serve an xgboost_tpu model over HTTP "
                    "(batched, one CUDA graph per row bucket)")
    p.add_argument("--model", required=True,
                   help="model file to serve (watched for hot-reload)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--quiet", action="store_true",
                   help="suppress startup banner and access logs")
    for name, (default, help_) in SERVE_PARAMS.items():
        flag = "--" + name[len("serve_"):].replace("_", "-")
        p.add_argument(flag, type=type(default), default=default,
                       help=f"{help_} (default {default})")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    from xgboost_tpu_torch.serving import run_server
    run_server(args.model, host=args.host, port=args.port,
               min_bucket=args.min_bucket, max_bucket=args.max_bucket,
               max_batch_rows=args.max_batch_rows,
               max_wait_ms=args.max_wait_ms,
               max_queue_rows=args.queue_rows, poll_sec=args.poll_sec,
               keep_versions=args.keep_versions,
               warmup=bool(args.warmup), drain_sec=args.drain_sec,
               max_body_mb=args.max_body_mb,
               featurestore_mb=args.featurestore_mb,
               router_url=args.router_url, replica_id=args.replica_id,
               advertise_url=args.advertise_url,
               quiet=args.quiet, block=True, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
