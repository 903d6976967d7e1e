from quest_tpu_torch.engine.engine import QuestEngine

__all__ = ["QuestEngine"]
