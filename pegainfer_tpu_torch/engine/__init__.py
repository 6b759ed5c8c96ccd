from pegainfer_tpu_torch.engine.contract import (  # noqa: F401
    EngineHandle,
    EngineLoadOptions,
    FinishReason,
    GenerateRequest,
    SamplingParams,
    TokenChannel,
)
from pegainfer_tpu_torch.engine.scheduler import Scheduler, start_scheduler  # noqa: F401
