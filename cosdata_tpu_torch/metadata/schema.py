"""Metadata schema (parity with upstream src/metadata/schema.rs).

A schema declares discrete-valued fields (<= 1024 values each,
schema.rs:130-446) and the supported query conditions. Values map to dense
value ids; unset fields get id -1.

Port of ``cosdata_tpu/metadata/schema.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

MAX_VALUES_PER_FIELD = 1024  # nearest_power_of_two ladder caps at 1024


class MetadataField:
    def __init__(self, name: str, values: list):
        if not name:
            raise ValueError("metadata field name required")
        if not values:
            raise ValueError(f"metadata field '{name}' needs at least one value")
        if len(values) > MAX_VALUES_PER_FIELD:
            raise ValueError(
                f"metadata field '{name}' exceeds {MAX_VALUES_PER_FIELD} values"
            )
        self.name = name
        self.values = list(values)
        self._id_of = {v: i for i, v in enumerate(self.values)}
        if len(self._id_of) != len(self.values):
            raise ValueError(f"duplicate values in metadata field '{name}'")

    def value_id(self, value) -> int:
        vid = self._id_of.get(value)
        if vid is None:
            raise ValueError(
                f"invalid value {value!r} for metadata field '{self.name}'"
            )
        return vid

    def to_dict(self) -> dict:
        return {"name": self.name, "values": self.values}


class MetadataSchema:
    def __init__(self, config: dict):
        fields = config.get("fields") or []
        self.fields = [MetadataField(f["name"], f["values"]) for f in fields]
        self.field_of = {f.name: f for f in self.fields}
        self.supported_conditions = config.get("supported_conditions") or []

    def value_ids(self, metadata: dict | None) -> dict[str, int]:
        """Vector metadata -> {field: value id}; missing fields get -1."""
        out = {}
        metadata = metadata or {}
        for f in self.fields:
            if f.name in metadata:
                out[f.name] = f.value_id(metadata[f.name])
            else:
                out[f.name] = -1
        unknown = set(metadata) - set(self.field_of)
        if unknown:
            raise ValueError(f"unknown metadata fields: {sorted(unknown)}")
        return out

    def to_dict(self) -> dict:
        return {
            "fields": [f.to_dict() for f in self.fields],
            "supported_conditions": self.supported_conditions,
        }
