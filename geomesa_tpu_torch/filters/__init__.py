"""Filters: AST, ECQL parser, extraction of index-consumable values, and
the host evaluator for residuals and exact geometry predicates."""

from . import ast
from .ecql import ECQLError, parse_ecql
from .evaluate import evaluate
from .helper import (extract_attribute_bounds, extract_geometries,
                     extract_intervals)

__all__ = ["ast", "ECQLError", "parse_ecql", "evaluate",
           "extract_attribute_bounds", "extract_geometries",
           "extract_intervals"]
