"""Recursive-descent parser for cosql.

Grammar (derived from the upstream project's nom parsers, src/cosql/):

    statement      := define_stmt | insert_stmt | match_stmt
    define_stmt    := "define" ("entity" entity_def
                               | "relationship" rel_def
                               | "rule" rule_def)
    entity_def     := name "as" attr_def ("," attr_def)* ";"
    attr_def       := name ":" data_type
    rel_def        := name "as" "(" role_def ("," role_def)* ")"
                      ("as" attr_def ("," attr_def)*)? ";"
    rule_def       := name "as" "match" patterns "infer"
                      ("derive"|"materialize") inference ";"
    insert_stmt    := "insert" (entity_insertion | rel_insertion)
    entity_insertion := "$"var "isa" type "(" attributes? ")" ";"
    rel_insertion  := "$"var? "(" roles ")" "forms" type ("(" attributes ")")? ";"
    match_stmt     := "match" patterns
                      ("compute" compute_clause ("," compute_clause)*)?
                      "get" "$"var ("," "$"var)* ";"
    pattern        := entity_pattern | rel_pattern | condition
    condition      := value binop value   (==, !=, <=, <, >=, >)
    expression     := precedence-climbing over + - * / ** == != < <= > >= and or,
                      unary - !, parens (expression.rs / precedence.rs)
    value          := string | double | int | date (dd-mm-yyyy) | bool | $var

Output AST is plain dicts (stable, serializable) with a "kind" tag.
"""

from __future__ import annotations

import re


class ParseError(ValueError):
    def __init__(self, msg: str, pos: int, text: str):
        line = text.count("\n", 0, pos) + 1
        col = pos - (text.rfind("\n", 0, pos) + 1) + 1
        super().__init__(f"{msg} at line {line}, column {col}")
        self.pos = pos


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<date>\d{1,2}-\d{1,2}-\d{1,5})
  | (?P<double>\d+\.\d+)
  | (?P<int>\d+)
  | (?P<var>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\*\*|==|!=|<=|>=|->|[()\[\]{},:;=<>+\-*/!])
""",
    re.VERBOSE,
)

_DATA_TYPES = {"string", "int", "double", "date", "boolean"}

# precedence.rs: logical < comparison < additive < multiplicative < exponent < unary
_BINOPS = {
    "or": 1,
    "and": 2,
    "==": 3, "!=": 3, "<": 3, "<=": 3, ">": 3, ">=": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5,
    "**": 6,
}
_COMPARISON = ("==", "!=", "<=", "<", ">=", ">")


class _Tokens:
    def __init__(self, text: str):
        self.text = text
        self.toks: list[tuple[str, str, int]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if m is None:
                raise ParseError(f"unexpected character {text[pos]!r}", pos, text)
            kind = m.lastgroup
            if kind not in ("ws", "comment"):
                self.toks.append((kind, m.group(), pos))
            pos = m.end()
        self.i = 0

    def peek(self, offset: int = 0):
        j = self.i + offset
        return self.toks[j] if j < len(self.toks) else (None, None, len(self.text))

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, value: str | None = None, kind: str | None = None):
        k, v, pos = self.peek()
        if (value is not None and v != value) or (kind is not None and k != kind):
            want = value or kind
            raise ParseError(f"expected {want!r}, found {v!r}", pos, self.text)
        return self.next()

    def accept(self, value: str) -> bool:
        if self.peek()[1] == value:
            self.next()
            return True
        return False

    @property
    def done(self) -> bool:
        return self.i >= len(self.toks)


# ---------------------------------------------------------------------------


def parse_statements(text: str) -> list[dict]:
    t = _Tokens(text)
    out = []
    while not t.done:
        out.append(_statement(t))
    return out


def parse_statement(text: str) -> dict:
    t = _Tokens(text)
    stmt = _statement(t)
    if not t.done:
        k, v, pos = t.peek()
        raise ParseError(f"trailing input {v!r}", pos, text)
    return stmt


def _statement(t: _Tokens) -> dict:
    k, v, pos = t.peek()
    if v == "define":
        t.next()
        k2, v2, pos2 = t.next()
        if v2 == "entity":
            return _entity_definition(t)
        if v2 == "relationship":
            return _relationship_definition(t)
        if v2 == "rule":
            return _rule(t)
        raise ParseError(f"expected entity/relationship/rule, found {v2!r}", pos2, t.text)
    if v == "insert":
        t.next()
        return _insertion(t)
    if v == "match":
        t.next()
        return _query(t)
    raise ParseError(f"expected define/insert/match, found {v!r}", pos, t.text)


# -- definitions -------------------------------------------------------------


def _name(t: _Tokens) -> str:
    return t.expect(kind="name")[1]


def _variable(t: _Tokens) -> str:
    return t.expect(kind="var")[1][1:]


def _attribute_definitions(t: _Tokens) -> list[dict]:
    out = []
    while True:
        name = _name(t)
        t.expect(":")
        k, v, pos = t.next()
        if v not in _DATA_TYPES:
            raise ParseError(f"unknown data type {v!r}", pos, t.text)
        out.append({"name": name, "data_type": v})
        if not t.accept(","):
            break
    return out


def _entity_definition(t: _Tokens) -> dict:
    name = _name(t)
    t.expect("as")
    attrs = _attribute_definitions(t)
    t.expect(";")
    return {"kind": "entity_definition", "name": name, "attributes": attrs}


def _relationship_definition(t: _Tokens) -> dict:
    name = _name(t)
    t.expect("as")
    t.expect("(")
    roles = []
    while True:
        rname = _name(t)
        t.expect(":")
        etype = _name(t)
        roles.append({"name": rname, "entity_type": etype})
        if not t.accept(","):
            break
    t.expect(")")
    attrs = []
    if t.accept("as"):
        attrs = _attribute_definitions(t)
    t.expect(";")
    return {
        "kind": "relationship_definition",
        "name": name,
        "roles": roles,
        "attributes": attrs,
    }


def _rule(t: _Tokens) -> dict:
    name = _name(t)
    t.expect("as")
    t.expect("match")
    patterns = _patterns(t, stop={"infer"})
    t.expect("infer")
    k, v, pos = t.next()
    if v not in ("derive", "materialize"):
        raise ParseError(f"expected derive/materialize, found {v!r}", pos, t.text)
    inference = _inference(t)
    t.expect(";")
    return {
        "kind": "rule",
        "name": name,
        "patterns": patterns,
        "inference_type": v,
        "inference": inference,
    }


# -- values / attributes ------------------------------------------------------


def _value(t: _Tokens) -> dict:
    k, v, pos = t.next()
    if k == "op" and v == "-":
        # negative literals: parse_value accepts opt('-') before int and
        # double (value.rs:45-50)
        k2, v2, pos2 = t.next()
        if k2 == "double":
            return {"kind": "double", "value": -float(v2)}
        if k2 == "int":
            return {"kind": "int", "value": -int(v2)}
        raise ParseError(f"expected a number after '-', found {v2!r}", pos2, t.text)
    if k == "string":
        return {"kind": "string", "value": v[1:-1].replace('\\"', '"')}
    if k == "date":
        d, m, y = v.split("-")
        return {"kind": "date", "value": [int(d), int(m), int(y)]}
    if k == "double":
        return {"kind": "double", "value": float(v)}
    if k == "int":
        return {"kind": "int", "value": int(v)}
    if k == "var":
        return {"kind": "variable", "value": v[1:]}
    if v in ("true", "false"):
        return {"kind": "boolean", "value": v == "true"}
    raise ParseError(f"expected a value, found {v!r}", pos, t.text)


def _attributes(t: _Tokens) -> list[dict]:
    """'(' name: value, ... ')' — values may be full expressions in
    inferences (expression.rs), plain values elsewhere; expressions subsume
    values so we always parse expressions and collapse plain ones."""
    out = []
    t.expect("(")
    if t.accept(")"):
        return out
    while True:
        name = _name(t)
        t.expect(":")
        expr = _expression(t)
        out.append({"name": name, "value": expr})
        if not t.accept(","):
            break
    t.expect(")")
    return out


# -- insertions ---------------------------------------------------------------


def _insertion(t: _Tokens) -> dict:
    var = _variable(t)
    if t.accept("isa"):
        etype = _name(t)
        attrs = _attributes(t)
        t.expect(";")
        return {
            "kind": "entity_insertion",
            "variable": var,
            "entity_type": etype,
            "attributes": attrs,
        }
    roles = _roles(t)
    t.expect("forms")
    rtype = _name(t)
    attrs = []
    if t.peek()[1] == "(":
        attrs = _attributes(t)
    t.expect(";")
    return {
        "kind": "relationship_insertion",
        "variable": var,
        "roles": roles,
        "relationship_type": rtype,
        "attributes": attrs,
    }


def _roles(t: _Tokens) -> list[dict]:
    """'(' [role:] $var, ... ')' (pattern/relationship.rs:31-58)."""
    t.expect("(")
    out = []
    while True:
        if t.peek()[0] == "name":
            rname = _name(t)
            t.expect(":")
            entity = _variable(t)
            out.append({"role": rname, "entity": entity})
        else:
            out.append({"role": None, "entity": _variable(t)})
        if not t.accept(","):
            break
    t.expect(")")
    return out


# -- patterns / query ----------------------------------------------------------


def _patterns(t: _Tokens, stop: set[str]) -> list[dict]:
    out = []
    while True:
        out.append(_pattern(t))
        if not t.accept(","):
            break
        if t.peek()[1] in stop:
            break
    return out


def _pattern(t: _Tokens) -> dict:
    k, v, pos = t.peek()
    if k == "var":
        k2, v2, _ = t.peek(1)
        if v2 == "isa":
            var = _variable(t)
            t.next()  # isa
            etype = _name(t)
            attrs = _attributes(t) if t.peek()[1] == "(" else []
            return {
                "kind": "entity_pattern",
                "variable": var,
                "entity_type": etype,
                "attributes": attrs,
            }
        if v2 == "(":
            var = _variable(t)
            roles = _roles(t)
            t.expect("forms")
            rtype = _name(t)
            attrs = _attributes(t) if t.peek()[1] == "(" else []
            return {
                "kind": "relationship_pattern",
                "variable": var,
                "roles": roles,
                "relationship_type": rtype,
                "attributes": attrs,
            }
        # condition: $var op value (condition.rs:65-120)
        left = _value(t)
        k3, op, pos3 = t.next()
        if op not in _COMPARISON:
            raise ParseError(f"expected comparison operator, found {op!r}", pos3, t.text)
        right = _value(t)
        return {"kind": "condition", "left": left, "operator": op, "right": right}
    if v == "(":
        roles = _roles(t)
        t.expect("forms")
        rtype = _name(t)
        attrs = _attributes(t) if t.peek()[1] == "(" else []
        return {
            "kind": "relationship_pattern",
            "variable": None,
            "roles": roles,
            "relationship_type": rtype,
            "attributes": attrs,
        }
    raise ParseError(f"expected a pattern, found {v!r}", pos, t.text)


def _query(t: _Tokens) -> dict:
    patterns = _patterns(t, stop={"get", "compute"})
    compute = []
    if t.accept("compute"):
        while True:
            var = _variable(t)
            t.expect("=")
            expr = _expression(t)
            compute.append({"variable": var, "expression": expr})
            if not t.accept(","):
                break
    t.expect("get")
    out_vars = [_variable(t)]
    while t.accept(","):
        out_vars.append(_variable(t))
    t.expect(";")
    return {
        "kind": "query",
        "patterns": patterns,
        "compute_clauses": compute,
        "get": out_vars,
    }


# -- inference ------------------------------------------------------------------


def _inference(t: _Tokens) -> dict:
    k, v, pos = t.peek()
    if k == "var" and t.peek(1)[1] == "isa":
        var = _variable(t)
        t.next()
        etype = _name(t)
        attrs = _attributes(t) if t.peek()[1] == "(" else []
        return {
            "kind": "entity_inference",
            "variable": var,
            "entity_type": etype,
            "attributes": attrs,
        }
    var = None
    if k == "var":
        var = _variable(t)
    roles = _roles(t)
    t.expect("forms")
    rtype = _name(t)
    attrs = _attributes(t) if t.peek()[1] == "(" else []
    return {
        "kind": "relationship_inference",
        "variable": var,
        "roles": roles,
        "relationship_type": rtype,
        "attributes": attrs,
    }


# -- expressions (precedence climbing, expression.rs + precedence.rs) -----------


def _expression(t: _Tokens, min_prec: int = 1) -> dict:
    left = _unary(t)
    while True:
        k, v, pos = t.peek()
        prec = _BINOPS.get(v)
        if prec is None or prec < min_prec:
            return left
        t.next()
        # ** is right-associative; the rest left-associative
        next_min = prec if v == "**" else prec + 1
        right = _expression(t, next_min)
        left = {"kind": "binary", "operator": v, "left": left, "right": right}


def _unary(t: _Tokens) -> dict:
    k, v, pos = t.peek()
    if v in ("-", "!"):
        t.next()
        return {"kind": "unary", "operator": v, "argument": _unary(t)}
    if v == "(":
        t.next()
        inner = _expression(t)
        t.expect(")")
        return inner
    return _value(t)
