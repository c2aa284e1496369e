"""The paper's duty-cycle model and runnable controller (port of the part
of ``repro.core`` that ``DutyCycleController`` needs; pure Python)."""
