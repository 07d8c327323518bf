"""Query filter compilation (parity with
upstream src/metadata/query_filtering.rs).

Accepted JSON shapes (serde externally-tagged enum):

    {"Is":  {"field_name": "color", "field_value": "red", "operator": "Equal"}}
    {"And": [predicate, ...]}
    {"Or":  [predicate, ...]}

``compile_filter`` returns a function mapping per-field value-id arrays
(dict field -> (N,) int array) to a boolean match mask — the array-native
equivalent of the reference's QueryFilterDimensions encoding.

Port of ``cosdata_tpu/metadata/filtering.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from cosdata_tpu_torch.metadata.schema import MetadataSchema


def _pred(schema: MetadataSchema, p: dict):
    name = p["field_name"]
    field = schema.field_of.get(name)
    if field is None:
        raise ValueError(f"unknown metadata field '{name}' in filter")
    vid = field.value_id(p["field_value"])
    op = p.get("operator", "Equal")
    if op not in ("Equal", "NotEqual"):
        raise ValueError(f"unknown operator {op!r}")
    return name, vid, op


def compile_filter(
    schema: MetadataSchema, filter_dto: dict
) -> Callable[[dict], np.ndarray]:
    """filter JSON -> fn(field_ids: {field: (N,) int array}) -> (N,) bool."""
    if not isinstance(filter_dto, dict) or len(filter_dto) != 1:
        raise ValueError("filter must be one of {'Is':..}/{'And':..}/{'Or':..}")
    kind, payload = next(iter(filter_dto.items()))

    if kind == "Is":
        preds = [_pred(schema, payload)]
        combine = all
    elif kind == "And":
        preds = [_pred(schema, p) for p in payload]
        combine = all
    elif kind == "Or":
        preds = [_pred(schema, p) for p in payload]
        combine = any
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    if not preds:
        raise ValueError("empty predicate list")

    def mask_fn(field_ids: dict, n: int | None = None) -> np.ndarray:
        masks = []
        for name, vid, op in preds:
            ids = field_ids.get(name)
            if ids is None:
                if n is None:
                    n = len(next(iter(field_ids.values()), np.zeros(0)))
                ids = np.full(n, -1, np.int64)
            m = ids == vid
            if op == "NotEqual":
                # NotEqual still requires the field to be present
                # (the reference's -1/1 encoding mismatches unset fields too)
                m = (ids != vid) & (ids >= 0)
            masks.append(m)
        stacked = np.stack(masks, axis=0)
        return stacked.all(axis=0) if combine is all else stacked.any(axis=0)

    return mask_fn
