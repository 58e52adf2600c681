"""Dev tools: the mock prover, the cost model, failures, tracing and
layout rendering (port of halo2_tpu/dev)."""
from .mock_prover import MockProver, POISON
from .cost import CircuitCost, CircuitGates, ProofSize
from .failure import (FailureLocation, CellNotAssigned,
                      ConstraintNotSatisfied, ConstraintPoisoned,
                      LookupFailure, PermutationFailure)
