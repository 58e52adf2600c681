"""Circuit API (copied from halo2_tpu/circuit/__init__.py without the
tracing hook and without the V1 floor planner, which the port does not
carry yet)."""
from .value import Value, SynthesisError
from .layouter import (Cell, AssignedCell, Region, Table, Layouter,
                       NamespacedLayouter, SingleChipLayouter, RegionShape,
                       Chip, Circuit, BatchRegion, BatchCell)


def synthesize_circuit(cs_assignment, circuit, config, constants,
                       plan_cache: dict | None = None):
    """Run the circuit's floor planner. Only the simple planner is
    ported; `plan_cache` (a mutable dict, e.g. held by the proving key)
    caches the layout across synthesis runs of the same circuit shape."""
    planner = getattr(type(circuit), "floor_planner", "simple")
    if planner != "simple":
        raise NotImplementedError(
            f"floor planner {planner!r} is not ported yet")
    plan = plan_cache.get("simple") if plan_cache is not None else None
    layouter = SingleChipLayouter(cs_assignment, constants, plan=plan)
    circuit.synthesize(config, layouter)
    if plan_cache is not None and plan is None:
        plan_cache["simple"] = layouter.recorded
