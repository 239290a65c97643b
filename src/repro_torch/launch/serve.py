"""Serving launcher: deploy an ensemble of archs behind a FlexServe endpoint
on one CUDA device.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --ensemble yi-9b yi-9b --full --port 8000

Without ``--full`` the members are the reduced smoke variants.  Weights
are random, drawn on the device from ``torch.Generator(seed + i)``.  The
flags of planes not ported yet (generate, model store, tracing, SLO,
replicas, faults) are not accepted.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduce_for_smoke
from repro_torch.core import Ensemble, EnsembleMember, ModelRegistry
from repro_torch.kernels.common import resolve_device
from repro_torch.models.build import build_model
from repro_torch.serving import FlexServeApp, FlexServeServer


def build_app(arch_names: Sequence[str], *, full: bool = False,
              num_classes: int = 16, max_batch: int = 8, seed: int = 0,
              device=None, max_queue: int = 64,
              default_deadline_ms: Optional[float] = None) -> FlexServeApp:
    """Members ``f"{name}#{i}"`` with params from seed ``seed + i`` on
    ``device`` (CUDA unless given; raises with no GPU and no device)."""
    device = resolve_device(device)
    registry = ModelRegistry()
    members = []
    for i, name in enumerate(arch_names):
        cfg = get_config(name)
        if not full:
            cfg = reduce_for_smoke(cfg)
        model = build_model(cfg)
        params = model.init(seed + i, device)
        reg_name = f"{name}#{i}"
        registry.register(reg_name, model, params)

        def apply(p, batch, _m=model, _c=num_classes):
            # classification readout: last-position logits over C classes
            return _m.forward(p, batch)[:, -1, :_c]

        members.append(EnsembleMember(reg_name, apply, params, num_classes))
    ensemble = Ensemble(members, max_batch=max_batch)
    return FlexServeApp(registry, ensemble, max_queue=max_queue,
                        default_deadline_ms=default_deadline_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ensemble", nargs="+", default=["yi-9b"],
                    choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--num-classes", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission budget (rows) for the infer plane; "
                         "excess load is shed as 429 + Retry-After")
    ap.add_argument("--default-deadline-ms", type=float, default=None,
                    help="deadline applied to requests that don't carry "
                         "one; past-deadline requests drop as 504 before "
                         "costing a forward pass")
    ap.add_argument("--full", action="store_true",
                    help="serve the archs at their configured size")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    app = build_app(args.ensemble, full=args.full,
                    num_classes=args.num_classes, max_batch=args.max_batch,
                    device=args.device,
                    max_queue=args.max_queue,
                    default_deadline_ms=args.default_deadline_ms)
    dev = app.ensemble.members[0].params["embed"].device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[serve] {len(app.ensemble.members)} member(s) on {dev} "
          f"({name}) in {time.perf_counter() - t0:.1f}s")
    server = FlexServeServer(app, host=args.host, port=args.port)
    host, port = server.address
    print(f"[serve] FlexServe endpoint on http://{host}:{port} — "
          f"{len(app.registry)} model(s): {app.registry.names()}")
    print("[serve] routes: GET /health /healthz /metrics /v1/models; "
          "POST /v1/infer /v1/detect")
    try:
        server.httpd.serve_forever()
    except KeyboardInterrupt:
        print("\n[serve] shutting down")
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
