"""Driver utilities of the port: preemption-safe training, experiment logs
and the profiling hooks (``trace``, ``timed``, ``StepTimer``)."""

from .profiling import StepTimer, timed, trace

__all__ = ["StepTimer", "timed", "trace"]
