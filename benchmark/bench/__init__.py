"""The benchmark harness of quest_tpu_torch (see benchmark/README.md)."""
