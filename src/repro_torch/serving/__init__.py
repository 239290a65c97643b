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
from repro_torch.serving.replica import Replica, ReplicaPool
from repro_torch.serving.server import FlexServeApp, FlexServeServer

__all__ = ["AdmissionController", "DeadlineError", "RequestContext",
           "ShedError", "BatchCoalescer", "CoalesceError", "FlexServeApp",
           "FlexServeServer", "FlexServeClient", "HTTPStatusError",
           "BadRequestError", "NotFoundError", "ConflictError",
           "QueueFullError", "UnavailableError", "DeadlineExceededError",
           "InternalServerError", "GenerationError", "GenerationService",
           "GenerationStream", "ReplicaPool", "Replica"]
