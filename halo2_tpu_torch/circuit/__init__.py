"""Circuit API (port of halo2_tpu/circuit/__init__.py): the simple and
the V1 floor planners, and the dev.tfp tracing hook."""
from .value import Value, SynthesisError
from .layouter import (Cell, AssignedCell, Region, Table, Layouter,
                       NamespacedLayouter, SingleChipLayouter, RegionShape,
                       Chip, Circuit, BatchRegion, BatchCell)


def synthesize_circuit(cs_assignment, circuit, config, constants,
                       plan_cache: dict | None = None):
    """Dispatch on the circuit's floor planner ('simple' | 'v1'), the
    associated-type choice of plonk/circuit.rs:469-471.

    `plan_cache` (a mutable dict, e.g. held by the proving key) caches
    the floor-plan layout across synthesis runs of the same circuit
    shape — repeat proofs skip the measurement pass entirely. Layout
    depends only on the shape, never on witness values (the contract
    V1's dual-pass relies on, v1.rs:60-141). A simple-planner layout in
    which a region's closure raised (and the circuit caught it, as the
    ECC tests do when they witness the identity as a non-identity point)
    is not cached: such a region takes no rows, and a replay could not
    tell it from the next one. V1's legacy region order
    is the circuit class's `legacy_pdqsort` attribute (default False)."""
    events = getattr(circuit, "_tfp_events", None)
    if events is not None:
        # dev.tfp.attach_tracing marked this circuit: interpose the
        # tracing sink (observation only — layout/vk/proof unchanged)
        from ..dev.tfp import wrap_sink
        cs_assignment = wrap_sink(cs_assignment, events)
    planner = getattr(type(circuit), "floor_planner", "simple")
    if planner == "v1":
        from .floor_planner_v1 import synthesize_v1
        plan = plan_cache.get("v1") if plan_cache is not None else None
        synthesize_v1(cs_assignment, circuit, config, constants,
                      plan=plan, plan_out=plan_cache,
                      legacy_pdqsort=getattr(type(circuit),
                                             "legacy_pdqsort", False))
    else:
        plan = plan_cache.get("simple") if plan_cache is not None else None
        layouter = SingleChipLayouter(cs_assignment, constants, plan=plan)
        circuit.synthesize(config, layouter)
        if (plan_cache is not None and plan is None
                and layouter.recorded.replayable):
            plan_cache["simple"] = layouter.recorded
