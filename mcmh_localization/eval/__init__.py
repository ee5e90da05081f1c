from mcmh_localization.eval.evaluator import (
    EvalResult,
    evaluate_run,
    save_results,
)

__all__ = ["EvalResult", "evaluate_run", "save_results"]
