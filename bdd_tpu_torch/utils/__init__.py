from bdd_tpu_torch.utils.logging import bdd_log, set_log_file, scoped_timer, timing_report

__all__ = ["bdd_log", "set_log_file", "scoped_timer", "timing_report"]
