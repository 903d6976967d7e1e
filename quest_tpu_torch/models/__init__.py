from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.llama import QuestModel, init_params

__all__ = ["QuestModel", "init_params", "params_from_numpy"]
