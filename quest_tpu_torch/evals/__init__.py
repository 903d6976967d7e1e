from quest_tpu_torch.evals.perplexity import evaluate_perplexity
from quest_tpu_torch.evals.passkey import (PasskeyResult,
                                           build_passkey_prompt,
                                           evaluate_passkey)
from quest_tpu_torch.evals.longbench import evaluate_longbench, predict_task
from quest_tpu_torch.evals.longbench_metrics import score_task
from quest_tpu_torch.evals.sim_attention import quest_sim_attention

__all__ = ["evaluate_perplexity", "PasskeyResult", "build_passkey_prompt",
           "evaluate_passkey", "evaluate_longbench", "predict_task",
           "score_task", "quest_sim_attention"]
