"""cosql, the declarative graph query language: its parser.

The port's own copy of ``cosdata_tpu/cosql/`` (the parser imports only
``re``): ``define entity/relationship/rule``, ``insert`` and ``match ...
get/compute/infer`` parse to the same plain dicts, and the same inputs
raise ``ParseError``. As in the reference and the upstream project, only
the parser ships: no evaluation engine is wired to the server.
"""

from cosdata_tpu_torch.cosql.parser import ParseError, parse_statement, parse_statements  # noqa: F401
