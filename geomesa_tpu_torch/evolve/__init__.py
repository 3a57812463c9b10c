"""Online reindex & schema evolution (shadow builds, WAL-tail
catch-up, crash-safe atomic flip). See evolver.py."""

from .evolver import (EVOLVE_CATCHUP_ROUNDS, EVOLVE_CATCHUP_SETTLE,
                      EVOLVE_ENABLED, EVOLVE_GATE_TIMEOUT_S, Evolver,
                      SchemaEvolutionError)

__all__ = ["Evolver", "SchemaEvolutionError", "EVOLVE_ENABLED",
           "EVOLVE_CATCHUP_ROUNDS", "EVOLVE_CATCHUP_SETTLE",
           "EVOLVE_GATE_TIMEOUT_S"]
