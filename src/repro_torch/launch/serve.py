"""Serving launcher: deploy an ensemble of archs behind a FlexServe endpoint
on one CUDA device.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --ensemble yi-9b yi-9b --full --port 8000

Without ``--full`` the members are the reduced smoke variants.  Weights
are random, drawn on the device from ``torch.Generator(seed + i)``.  The
first member whose family decodes also serves /v1/generate (blocking and
``"stream": true``) through the continuous-batching scheduler, on the
same params; ``--replicas N`` puts N decode schedulers behind a
health-checked pool and ``--fault-config`` arms a chaos drill.

With ``--model-store DIR`` the endpoint is store-backed: member params are
published to (on first run) or loaded from a versioned on-disk model store
with provenance manifests, and the server exposes the lifecycle admin
surface (GET /v1/models/{name}, POST .../load /unload /rollback /gc, plus
POST /v1/engines/{name}/load|rollback for the generation engine) for hot
swaps under traffic.  Tracing is on unless ``--no-trace``
(``--flight-recorder-size`` sealed traces stay queryable);
``--profile-dir`` enables ``POST /v1/debug/profile``; ``--slo-config``
starts the SLO autopilot.  ``--draft-model`` (with ``--draft-layers``
and ``--spec-window``) serves the generate plane through a speculative
pair: the draft, seeded ``seed + 1000``, proposes and the member verifies;
seeded outputs equal non-speculative decoding, and a request opts out
with ``"speculation": false``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduce_for_smoke
from repro_torch.core import (Ensemble, EnsembleMember, FaultInjector,
                              InferenceEngine, ModelRegistry,
                              SpeculativeEngine)
from repro_torch.kernels.common import resolve_device
from repro_torch.models.build import build_model
from repro_torch.serving import (FlexServeApp, FlexServeServer, ModelManager,
                                 ModelStore)


# the families the launcher gives a generate plane, as the JAX launcher
# does: vlm and encdec decode only with image or audio extras, which no
# route passes
DECODE_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def draft_config(draft_model: str, *, full: bool, draft_layers=None):
    """The draft's config: the arch (reduced unless ``full``), cut to
    ``draft_layers`` layers when given."""
    dcfg = get_config(draft_model)
    if not full:
        dcfg = reduce_for_smoke(dcfg)
    if draft_layers:
        dcfg = dataclasses.replace(dcfg, num_layers=int(draft_layers))
    return dcfg


def build_app(arch_names: Sequence[str], *, full: bool = False,
              num_classes: int = 16, max_len: int = 256, max_batch: int = 8,
              seed: int = 0, device=None, num_slots: int = 4,
              max_queue: int = 64,
              generate_token_budget: Optional[int] = None,
              default_deadline_ms: Optional[float] = None,
              trace: bool = True, flight_recorder_size: int = 256,
              profile_dir: Optional[str] = None, slo_config=None,
              client_weights: Optional[Dict[str, float]] = None,
              draft_model: Optional[str] = None,
              draft_layers: Optional[int] = None, spec_window: int = 4,
              replicas: int = 1, fault_config=None) -> FlexServeApp:
    """Members ``f"{name}#{i}"`` with params from seed ``seed + i`` on
    ``device`` (CUDA unless given; raises with no GPU and no device).  The
    generate plane runs an ``InferenceEngine`` over the first member whose
    family decodes, on that member's params (no second copy); with
    ``draft_model`` it runs a ``SpeculativeEngine`` of that engine and a
    draft seeded ``seed + 1000``."""
    device = resolve_device(device)
    registry = ModelRegistry()
    members = []
    engine = None
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
        if engine is None and cfg.family in DECODE_FAMILIES:
            engine = InferenceEngine(model, params, max_len=max_len,
                                     max_batch=max_batch)
    if engine is not None and draft_model is not None:
        # speculative pair: a (usually shallower) draft proposes, the
        # target verifies — seeded output is the same either way
        dcfg = draft_config(draft_model, full=full,
                            draft_layers=draft_layers)
        dmodel = build_model(dcfg)
        engine = SpeculativeEngine(
            engine,
            InferenceEngine(dmodel, dmodel.init(seed + 1000, device),
                            max_len=max_len, max_batch=max_batch),
            max_window=spec_window)
        print(f"[serve] speculative decoding: draft {draft_model} "
              f"({dcfg.num_layers} layers) proposing up to "
              f"{engine.max_window} tokens/tick")
    ensemble = Ensemble(members, max_batch=max_batch)
    return FlexServeApp(registry, ensemble, engine, num_slots=num_slots,
                        max_queue=max_queue,
                        generate_token_budget=generate_token_budget,
                        default_deadline_ms=default_deadline_ms,
                        trace=trace,
                        flight_recorder_size=flight_recorder_size,
                        profile_dir=profile_dir, slo_policies=slo_config,
                        client_weights=client_weights,
                        replicas=replicas, fault_config=fault_config)


def build_store_app(arch_names: Sequence[str], store_dir: str, *,
                    full: bool = False, num_classes: int = 16,
                    max_len: int = 256, max_batch: int = 8, seed: int = 0,
                    device=None, num_slots: int = 4, max_queue: int = 64,
                    generate_token_budget: Optional[int] = None,
                    default_deadline_ms: Optional[float] = None,
                    trace: bool = True, flight_recorder_size: int = 256,
                    profile_dir: Optional[str] = None, slo_config=None,
                    client_weights: Optional[Dict[str, float]] = None,
                    draft_model: Optional[str] = None,
                    draft_layers: Optional[int] = None, spec_window: int = 4,
                    replicas: int = 1, fault_config=None) -> FlexServeApp:
    """Store-backed startup: seed the store on first run (member
    ``f"{name}#{i}"`` from seed ``seed + i``), then serve the LATEST
    published version of every member through a ModelManager on ``device``
    (CUDA unless given).  The generation engine is ALSO store-versioned:
    the first decode-capable member is loaded through the manager's engine
    plane, so it can be hot-swapped / rolled back under live streaming
    traffic.  A store seeded by another publisher is served as its
    manifests describe it (``reduced``, ``num_layers``, ``num_classes``,
    ``max_len``, ``max_batch``).  With ``draft_model`` the draft is
    published (first run) as ``f"{draft_model}#draft"``, its manifest
    recording its depth, and loaded with the engine as one pair."""
    device = resolve_device(device)
    store = ModelStore(store_dir)
    member_names = []
    engine_member = None
    for i, name in enumerate(arch_names):
        reg_name = f"{name}#{i}"
        member_names.append(reg_name)
        cfg = get_config(name)
        if not full:
            cfg = reduce_for_smoke(cfg)
        if store.latest_version(reg_name) is None:
            params = build_model(cfg).init(seed + i, device)
            v = store.publish(reg_name, params, config=name,
                              source=cfg.source,
                              meta={"reduced": not full,
                                    "num_classes": num_classes,
                                    "init_seed": seed + i,
                                    "max_len": max_len,
                                    "max_batch": max_batch})
            del params
            print(f"[serve] published {reg_name} v{v} to {store_dir}")
        if engine_member is None and cfg.family in DECODE_FAMILIES:
            engine_member = reg_name
    # one injector shared end-to-end: decode drivers + replica monitor
    # (pool), the stream writer (handler) and checkpoint loads (manager)
    # all draw from the same deterministic schedule
    faults = FaultInjector.load(fault_config)
    manager = ModelManager(store, max_batch=max_batch, faults=faults,
                           device=device)
    manager.bootstrap(member_names)
    app = FlexServeApp(manager=manager, num_slots=num_slots,
                       max_queue=max_queue,
                       generate_token_budget=generate_token_budget,
                       default_deadline_ms=default_deadline_ms,
                       trace=trace,
                       flight_recorder_size=flight_recorder_size,
                       profile_dir=profile_dir, slo_policies=slo_config,
                       client_weights=client_weights,
                       replicas=replicas, fault_config=faults)
    if engine_member is not None and app.generation is not None:
        draft_member = None
        if draft_model is not None:
            # the draft checkpoint is its own store model, so the pair
            # rides the engine lifecycle: load / canary / promote /
            # rollback move target and draft as one unit
            draft_member = f"{draft_model}#draft"
            if store.latest_version(draft_member) is None:
                dcfg = draft_config(draft_model, full=full,
                                    draft_layers=draft_layers)
                dparams = build_model(dcfg).init(seed + 1000, device)
                v = store.publish(draft_member, dparams, config=draft_model,
                                  source=dcfg.source,
                                  meta={"reduced": not full,
                                        "num_classes": num_classes,
                                        "num_layers": dcfg.num_layers,
                                        "init_seed": seed + 1000,
                                        "max_len": max_len,
                                        "max_batch": max_batch})
                del dparams
                print(f"[serve] published draft {draft_member} v{v}")
        res = manager.load_engine(engine_member, draft=draft_member,
                                  max_window=spec_window)
        print(f"[serve] generation engine {res['engine']} "
              f"(alias {res['alias']})"
              + (f" + draft {res['draft']}" if res.get("draft") else ""))
    return app


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ensemble", nargs="+", default=["yi-9b"],
                    choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--num-classes", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--num-slots", type=int, default=4,
                    help="continuous-batching decode slots per replica")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission budget (rows) for the infer plane; "
                         "excess load is shed as 429 + Retry-After")
    ap.add_argument("--generate-token-budget", type=int, default=None,
                    help="generate-plane admission budget in TOKEN units "
                         "(prompt + requested max_new_tokens per request; "
                         "default 32 * max-queue)")
    ap.add_argument("--default-deadline-ms", type=float, default=None,
                    help="deadline applied to requests that don't carry "
                         "one; past-deadline requests drop as 504 before "
                         "costing a forward pass")
    ap.add_argument("--model-store", default=None, metavar="DIR",
                    help="versioned model store directory; enables the "
                         "lifecycle admin API and hot swaps")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable per-request tracing + the flight "
                         "recorder (GET /v1/trace/{id} 404s)")
    ap.add_argument("--flight-recorder-size", type=int, default=256,
                    help="completed request timelines kept queryable "
                         "via GET /v1/trace/{id}")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="enable POST /v1/debug/profile; captures land "
                         "under this directory")
    ap.add_argument("--slo-config", default=None, metavar="FILE",
                    help="JSON SLO policy file ({'policies': [...]}); "
                         "enables the SLO autopilot: windowed burn-rate "
                         "evaluation with automatic canary promotion / "
                         "rollback, auditable at GET /v1/slo")
    ap.add_argument("--replicas", type=int, default=1,
                    help="generate-plane scheduler replicas behind the "
                         "endpoint; >1 enables the health-checked replica "
                         "pool with automatic cordon/restart and "
                         "transparent stream failover (GET /v1/replicas, "
                         "POST /v1/replicas/{id}/cordon|uncordon)")
    ap.add_argument("--fault-config", default=None, metavar="FILE",
                    help="JSON fault schedule ({'faults': [...]}) for "
                         "deterministic chaos drills: inject raises/"
                         "stalls/drops at named sites (engine_step, "
                         "decode_tick, prefill, engine_install, "
                         "checkpoint_load, socket_drop, replica_kill)")
    ap.add_argument("--client-weight", action="append", default=None,
                    metavar="TAG=W",
                    help="per-client-tag fair-share weight (repeatable); "
                         "any weight enables weighted admission quotas + "
                         "weighted fair dequeue on the generate plane "
                         "(unlisted tags weigh 1.0)")
    ap.add_argument("--draft-model", default=None, metavar="ARCH",
                    choices=list(ASSIGNED_ARCHS),
                    help="enable speculative decoding: serve this arch as "
                         "the draft proposer (usually with --draft-layers "
                         "to truncate its depth); seeded outputs equal "
                         "non-speculative decoding, and requests opt out "
                         "per call with \"speculation\": false")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="truncate the draft model to this many layers "
                         "(a shallow draft is what makes proposing cheap)")
    ap.add_argument("--spec-window", type=int, default=4,
                    help="max draft tokens proposed per decode tick; the "
                         "scheduler adapts the live window to measured "
                         "acceptance")
    ap.add_argument("--full", action="store_true",
                    help="serve the archs at their configured size")
    args = ap.parse_args(argv)

    client_weights = None
    if args.client_weight:
        client_weights = {}
        for spec in args.client_weight:
            tag, sep, w = spec.partition("=")
            if not sep or not tag:
                ap.error(f"--client-weight needs TAG=WEIGHT, got {spec!r}")
            try:
                client_weights[tag] = float(w)
            except ValueError:
                ap.error(f"--client-weight {spec!r}: weight must be a "
                         f"number")

    kw = dict(full=args.full, num_classes=args.num_classes,
              max_len=args.max_len, max_batch=args.max_batch,
              device=args.device, num_slots=args.num_slots,
              max_queue=args.max_queue,
              generate_token_budget=args.generate_token_budget,
              default_deadline_ms=args.default_deadline_ms,
              trace=not args.no_trace,
              flight_recorder_size=args.flight_recorder_size,
              profile_dir=args.profile_dir, slo_config=args.slo_config,
              client_weights=client_weights, draft_model=args.draft_model,
              draft_layers=args.draft_layers, spec_window=args.spec_window,
              replicas=args.replicas, fault_config=args.fault_config)
    t0 = time.perf_counter()
    if args.model_store:
        app = build_store_app(args.ensemble, args.model_store, **kw)
    else:
        app = build_app(args.ensemble, **kw)
    dev = app.ensemble.members[0].params["embed"].device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[serve] {len(app.ensemble.members)} member(s) on {dev} "
          f"({name}) in {time.perf_counter() - t0:.1f}s")
    if (app.generation is not None and app.generation.ready
            and app.manager is None):
        # run the decode data path once (prefill buckets, sampler, tick)
        # so the first live streams never pay for kernel builds or the
        # allocator's growth.  Store-backed boots skip this: the manager's
        # load_engine already warmed before flipping the alias.
        warm_s = app.generation.entry_for().service.warm()
        print(f"[serve] decode path warm in {warm_s:.1f}s")
    if args.replicas > 1:
        print(f"[serve] replica pool: {args.replicas} decode replicas "
              f"(health-checked; GET /v1/replicas)")
    if args.fault_config:
        print(f"[serve] chaos: fault schedule armed from "
              f"{args.fault_config}")
    server = FlexServeServer(app, host=args.host, port=args.port)
    host, port = server.address
    print(f"[serve] FlexServe endpoint on http://{host}:{port} — "
          f"{len(app.registry)} model(s): {app.registry.names()}")
    print("[serve] routes: GET /health /healthz /metrics[?format="
          "prometheus] /v1/trace/{id} /v1/traces /v1/usage /v1/slo "
          "/v1/models /v1/models/{name} /v1/engines /v1/replicas; POST "
          "/v1/infer /v1/detect /v1/generate (+\"stream\": true for token "
          "streaming) /v1/replicas/{id}/cordon|uncordon"
          + (" /v1/debug/profile" if args.profile_dir else "")
          + (" /v1/models/{name}/load|unload|rollback|gc "
             "/v1/engines/{name}/load|rollback"
             if app.manager else ""))
    if app.slo is not None:
        print(f"[serve] SLO autopilot: "
              f"{app.slo.stats()['policies']} policy(ies) from "
              f"{args.slo_config} — decisions audit at GET /v1/slo")
    try:
        server.httpd.serve_forever()
    except KeyboardInterrupt:
        print("\n[serve] shutting down")
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
