"""Closed-loop control over the obs stream (``recover``): verdicts and SLO
violations become typed ``recovery_action`` events.  numpy and stdlib
only: controllers consume streams, they grow no hooks inside the
simulator."""
from .recover import (RecoveryPolicy, apply_actions, attach_actions,
                      plan_from_result, plan_recovery,
                      unrecovered_violations)

__all__ = ["RecoveryPolicy", "plan_recovery", "plan_from_result",
           "apply_actions", "attach_actions", "unrecovered_violations"]
