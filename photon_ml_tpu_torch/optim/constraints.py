"""Box constraints on coefficients (port of photon_ml_tpu/optim/constraints.py).

Reference spec: optimization/OptimizationUtils.scala:30-80
(projectCoefficientsToHypercube: per-index clipping to (lower, upper)) and
io/GLMSuite.scala:207-270 (createConstraintFeatureMap: a JSON constraint
string -> {feature index: (lowerBound, upperBound)} with wildcards; keys of
io/ConstraintMapKeys.scala).

The map is densified once into ``(D,)`` lower and upper tensors (+/-inf
where a coordinate is free), so the projection is one ``torch.clamp`` that
broadcasts over a solver's lanes.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

WILDCARD = "*"
DELIMITER = "\x01"
# the reference's name-and-term key of the intercept, as the JAX module has
# it; the index maps of both packages name the intercept "(INTERCEPT)", so a
# full wildcard constrains the intercept too, in both packages
INTERCEPT_KEY = "(INTERCEPT)" + DELIMITER

# JSON keys (ConstraintMapKeys.scala)
NAME_KEY = "name"
TERM_KEY = "term"
LOWER_BOUND_KEY = "lowerBound"
UPPER_BOUND_KEY = "upperBound"


Bounds = Optional[Tuple[Tensor, Tensor]]


def as_bounds(bounds: Bounds, like: Tensor) -> Bounds:
    """A solver's ``(lower, upper)`` pair in the dtype and on the device of
    its coefficients ``like``; None stays None."""
    if bounds is None:
        return None
    return tuple(torch.as_tensor(b, dtype=like.dtype, device=like.device) for b in bounds)


@dataclasses.dataclass(frozen=True)
class BoxConstraints:
    """Dense (lower, upper) bound arrays of shape (D,)."""

    lower: Tensor
    upper: Tensor

    def project(self, w: Tensor) -> Tensor:
        return torch.clamp(w, self.lower, self.upper)

    @property
    def dim(self) -> int:
        return self.lower.shape[0]

    @staticmethod
    def from_map(dim: int, constraint_map: Mapping[int, Tuple[float, float]],
                 device=None) -> "BoxConstraints":
        lower = np.full((dim,), -np.inf, np.float32)
        upper = np.full((dim,), np.inf, np.float32)
        for idx, (lb, ub) in constraint_map.items():
            lower[idx] = lb
            upper[idx] = ub
        return BoxConstraints(torch.from_numpy(lower).to(device),
                              torch.from_numpy(upper).to(device))


def parse_constraint_string(
    constraint_string: str,
    feature_key_to_index: Mapping[str, int],
    intercept_key: Optional[str] = INTERCEPT_KEY,
) -> Optional[Dict[int, Tuple[float, float]]]:
    """JSON constraint string -> {feature index: (lower, upper)}.

    Mirrors GLMSuite.createConstraintFeatureMap (io/GLMSuite.scala:207-270):

      * each entry must carry "name" and "term"; missing bounds default to
        -inf / +inf, but at least one must be finite and lower < upper;
      * name "*" + term "*" constrains every feature except the intercept
        and must be the only entry;
      * name "*" with a concrete term is rejected (unsupported);
      * a concrete name with term "*" constrains every feature whose key
        starts with ``name + DELIMITER``;
      * duplicate coverage of the same feature index is rejected;
      * returns None when the resulting map is empty.
    """
    entries = json.loads(constraint_string)
    if not isinstance(entries, list):
        raise ValueError(f"Constraint string must be a JSON list: {constraint_string!r}")

    constraint_map: Dict[int, Tuple[float, float]] = {}
    saw_full_wildcard = False
    for entry in entries:
        if NAME_KEY not in entry or TERM_KEY not in entry:
            raise ValueError(
                f"Each constraint map entry needs '{NAME_KEY}' and '{TERM_KEY}': {entry!r}"
            )
        name = entry[NAME_KEY]
        term = entry[TERM_KEY]
        lb = float(entry.get(LOWER_BOUND_KEY, -math.inf))
        ub = float(entry.get(UPPER_BOUND_KEY, math.inf))
        if not (lb > -math.inf or ub < math.inf):
            raise ValueError(
                f"Both bounds infinite for feature name={name!r} term={term!r} — "
                "invalid constraint specification"
            )
        if not lb < ub:
            raise ValueError(
                f"Lower bound {lb} >= upper bound {ub} for feature name={name!r} term={term!r}"
            )

        if name == WILDCARD:
            if term != WILDCARD:
                raise ValueError(
                    "Wildcard in feature name alone is not supported; wildcard name "
                    "requires wildcard term"
                )
            saw_full_wildcard = True
            for key, idx in feature_key_to_index.items():
                if intercept_key is not None and key == intercept_key:
                    continue
                constraint_map[idx] = (lb, ub)
        elif term == WILDCARD:
            prefix = name + DELIMITER
            for key, idx in feature_key_to_index.items():
                if key.startswith(prefix):
                    if idx in constraint_map:
                        raise ValueError(
                            f"Conflicting bounds for feature key {key!r}: already "
                            f"{constraint_map[idx]}, attempted {(lb, ub)}"
                        )
                    constraint_map[idx] = (lb, ub)
        else:
            idx = feature_key_to_index.get(name + DELIMITER + term)
            if idx is not None:
                if idx in constraint_map:
                    raise ValueError(
                        f"Conflicting bounds for feature name={name!r} term={term!r}: "
                        f"already {constraint_map[idx]}, attempted {(lb, ub)}"
                    )
                constraint_map[idx] = (lb, ub)

    if saw_full_wildcard and len(entries) > 1:
        raise ValueError(
            "When name and term are both wildcards no other constraints may be "
            f"specified: {constraint_string!r}"
        )

    return constraint_map or None
