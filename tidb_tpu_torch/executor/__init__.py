from .engine import ExecContext, run_physical

__all__ = ["ExecContext", "run_physical"]
