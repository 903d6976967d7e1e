from quest_tpu_torch.engine.engine import QuestEngine
from quest_tpu_torch.engine.scheduler import (ContinuousBatchingEngine,
                                              Request, StepEvent)

__all__ = ["ContinuousBatchingEngine", "QuestEngine", "Request",
           "StepEvent"]
