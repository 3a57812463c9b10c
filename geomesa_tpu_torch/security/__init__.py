"""Cell-level visibility (geomesa-security analog).

VisibilityEvaluator (security/VisibilityEvaluator.scala:21) parses
Accumulo-style boolean visibility expressions — ``A&B|(C&D)``, quoted
terms — and evaluates them against a user's authorization set, so the
store enforces row- and attribute-level access.
"""

from .visibility import (VisibilityExpression, evaluate_visibilities,
                         parse_visibility, validate_labels)

__all__ = ["VisibilityExpression", "evaluate_visibilities",
           "parse_visibility", "validate_labels"]
