"""The eval launchers, run as modules: ``python -m
quest_tpu_torch.scripts.{ppl_eval,passkey,longbench} ...``."""
