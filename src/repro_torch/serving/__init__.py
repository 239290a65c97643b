from repro_torch.core.slo import (SLIStore, SLOController, SLOPolicy,
                                  UsageLedger, load_policies)
from repro_torch.serving.admission import (AdmissionController, DeadlineError,
                                           RequestContext, ShedError)
from repro_torch.serving.client import (BadRequestError, ConflictError,
                                        DeadlineExceededError,
                                        FlexServeClient, HTTPStatusError,
                                        InternalServerError, NotFoundError,
                                        QueueFullError, UnavailableError)
from repro_torch.serving.coalesce import BatchCoalescer, CoalesceError
from repro_torch.serving.generate import (GenerationError, GenerationService,
                                          GenerationStream)
from repro_torch.serving.lifecycle import (LifecycleError, ModelManager,
                                           default_engine_factory,
                                           default_factory)
from repro_torch.serving.modelstore import ModelStore, StoreError
from repro_torch.serving.replica import Replica, ReplicaPool
from repro_torch.serving.server import FlexServeApp, FlexServeServer
from repro_torch.serving.telemetry import (DeviceProfiler, FlightRecorder,
                                           Trace, prometheus_exposition)

__all__ = ["AdmissionController", "DeadlineError", "RequestContext",
           "ShedError", "BatchCoalescer", "CoalesceError", "FlexServeApp",
           "FlexServeServer", "FlexServeClient", "HTTPStatusError",
           "BadRequestError", "NotFoundError", "ConflictError",
           "QueueFullError", "UnavailableError", "DeadlineExceededError",
           "InternalServerError", "GenerationError", "GenerationService",
           "GenerationStream", "ReplicaPool", "Replica", "ModelStore",
           "StoreError", "ModelManager", "LifecycleError",
           "default_factory", "default_engine_factory", "FlightRecorder",
           "Trace", "DeviceProfiler", "prometheus_exposition", "SLIStore",
           "SLOController", "SLOPolicy", "UsageLedger", "load_policies"]
