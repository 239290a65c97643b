"""An ensemble of dense GQA members behind ``FlexServeServer``, assembled
as the port's launcher (``launch/serve.py::build_app``) does: a
``ModelRegistry``, one ``EnsembleMember`` per member with the readout that
``serving/lifecycle.py::default_factory`` gives, an ``Ensemble`` and a
``FlexServeApp``; no generate plane.

The weights are the benchmark's own (``harness/weights.py``).  Each
member's readout is wrapped once, to keep a copy of the (rows, C) logits
it returns beside the token ids it was given: what the route's answers
were computed from, for the check after the window."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from perfbench.harness import weights as wmod


class LogitsRecorder:
    """Copies of every forward's readout while ``on``."""

    def __init__(self):
        self.on = False
        self.items: List[Tuple[str, torch.Tensor, torch.Tensor]] = []
        self._lock = threading.Lock()

    def wrap(self, name: str, apply):
        def recorded(params, batch):
            out = apply(params, batch)
            if self.on:
                with self._lock:
                    # copies of both: the program may reuse its buffers
                    self.items.append((name,
                                       batch["tokens"].detach().clone(),
                                       out.detach().clone()))
            return out
        return recorded

    def read(self) -> Tuple[Dict[bytes, Dict[str, np.ndarray]],
                            List[Tuple[int, int]]]:
        """({token ids of a row, as bytes: {member: its logits (C,)
        float32}}, [(rows, of which padding) per forward]); rows of all
        zeros (the batcher's padding) are left out of the first."""
        out: Dict[bytes, Dict[str, np.ndarray]] = {}
        forwards: List[Tuple[int, int]] = []
        with self._lock:
            items = list(self.items)
        first = items[0][0] if items else None
        for name, tokens, logits in items:
            tok = tokens.cpu().numpy().astype(np.int32)
            lg = logits.float().cpu().numpy()
            real = tok.any(axis=1)
            if name == first:
                forwards.append((len(real), int((~real).sum())))
            for r in np.flatnonzero(real):
                out.setdefault(tok[r].tobytes(), {})[name] = lg[r]
        return out, forwards

    def clear(self) -> None:
        with self._lock:
            self.items.clear()


class Deployment:
    """The app and its server, the members' weights and the recorder."""

    def __init__(self, config: Mapping, seed: int, device, trace: bool):
        t = time.perf_counter()
        from repro_torch.core import Ensemble, EnsembleMember, ModelRegistry
        from repro_torch.serving import FlexServeApp, FlexServeServer
        from repro_torch.serving.lifecycle import default_factory
        self.timings: Dict[str, float] = {
            "imports_s": time.perf_counter() - t, "members_s": 0.0,
            "weights_s": 0.0}

        arch = config["arch"]
        layout = wmod.dense_gqa_layout(arch)
        self.recorder = LogitsRecorder()
        self.weights: List[Dict[str, torch.Tensor]] = []
        self.member_names: List[str] = []
        registry = ModelRegistry()
        members = []
        C = int(config["num_classes"])
        for i, arch_name in enumerate(config["members"]):
            t = time.perf_counter()
            model, apply, nc = default_factory(
                {"config": arch_name, "reduced": bool(config["port_reduced"]),
                 "num_classes": C})
            check_arch(model.config, arch)
            self.timings["members_s"] += time.perf_counter() - t
            t = time.perf_counter()
            params = wmod.make(layout, seed, i, device)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            self.timings["weights_s"] += time.perf_counter() - t
            name = f"{arch_name}#{i}"
            registry.register(name, model, params)
            members.append(EnsembleMember(
                name, self.recorder.wrap(name, apply), params, nc))
            self.weights.append(params)
            self.member_names.append(name)
        t = time.perf_counter()
        ensemble = Ensemble(members, max_batch=int(config["max_batch"]))
        self.app = FlexServeApp(registry, ensemble, None,
                                max_queue=int(config["max_queue"]),
                                trace=trace)
        self.server = FlexServeServer(self.app, host="127.0.0.1", port=0)
        self.server.start()
        self.host, self.port = self.server.address[:2]
        self.timings["server_s"] = time.perf_counter() - t
        self.buckets = ensemble.batch_buckets.sizes

    @staticmethod
    def launches() -> Dict[str, int]:
        """The program's own launch counters (K1's forward wrapper)."""
        from repro_torch.kernels.flash_attention import flash_attention
        return {"k1": int(flash_attention.launches)}

    def warm_shapes(self, shapes) -> List[Tuple[int, int]]:
        """(rows, seq_len) of one request per bucket that the mix's
        requests can reach: a request of ``rows`` rows alone, or merged
        with others up to the largest bucket."""
        out = {(b, seq) for rows, seq in shapes for b in self.buckets
               if b >= rows}
        return sorted(out, key=lambda t: (t[1], t[0]))

    def close(self) -> None:
        """Stop the server and the app's threads; drop the program's
        state (the weights stay with the benchmark)."""
        self.server.stop()
        self.recorder.clear()
        self.app = None
        self.server = None


def check_layout(like: Mapping[str, torch.Tensor], layout: Mapping,
                 arch_name: str) -> None:
    """The benchmark's keys, shapes and dtypes are the port's
    (``model.like()``; a test holds each configuration to it: on the
    card's torch a meta init of a 48-layer model takes seconds)."""
    ours = {k: (tuple(s), dt) for k, (s, dt, _) in layout.items()}
    theirs = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
              for k, t in like.items()}
    if ours != theirs:
        diff = sorted(set(ours.items()) ^ set(theirs.items()))
        raise ValueError(f"{arch_name}: the benchmark's weight layout is "
                         f"not the port's: {diff[:6]}")


def check_arch(cfg: Any, arch: Mapping) -> None:
    """The sizes the reference and the cost count use are the ones the
    port runs."""
    for key in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                "head_dim", "d_ff", "vocab_size", "sliding_window",
                "rope_theta", "norm_eps", "dtype"):
        if getattr(cfg, key) != arch[key]:
            raise ValueError(f"{cfg.name}: {key} is {getattr(cfg, key)!r} "
                             f"in the port, {arch[key]!r} in the "
                             f"benchmark's configuration")
    if (cfg.norm_kind, cfg.act, cfg.attn_kind, cfg.use_bias,
            cfg.use_qk_norm, cfg.parallel_block, cfg.tie_embeddings,
            cfg.logit_softcap) != ("rmsnorm", "swiglu", "gqa", False, False,
                                   False, False, None):
        raise ValueError(f"{cfg.name} is not the plain dense GQA block "
                         f"the reference computes")


def build(config: Mapping, seed: int, device, trace: bool) -> Deployment:
    return Deployment(config, seed, device, trace)
