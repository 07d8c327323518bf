"""Metadata schema + filtered search.

API parity with upstream src/metadata/ (schema.rs, query_filtering.rs):
fields with up to 1024 discrete values, filters Is/And/Or over Eq/Ne
predicates.

Re-design: the reference encodes values as ±weight binary dims and inserts
per-combination *replica nodes* under a pseudo-root (metadata/mod.rs:127-212)
so filtered traversal stays inside the graph. Here a filter compiles to a
boolean mask over store rows from per-field value-id arrays, applied inside
the masked exact scan. Observable behavior (which vectors match) is
identical.

Port of ``cosdata_tpu/metadata/__init__.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from cosdata_tpu_torch.metadata.schema import MetadataSchema  # noqa: F401
from cosdata_tpu_torch.metadata.filtering import compile_filter  # noqa: F401
