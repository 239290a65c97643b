from repro_torch.serving.admission import (AdmissionController, DeadlineError,
                                           RequestContext, ShedError)
from repro_torch.serving.coalesce import BatchCoalescer, CoalesceError
from repro_torch.serving.server import FlexServeApp, FlexServeServer

__all__ = ["AdmissionController", "DeadlineError", "RequestContext",
           "ShedError", "BatchCoalescer", "CoalesceError", "FlexServeApp",
           "FlexServeServer"]
