"""The port's cosql parser (cosdata_tpu_torch/cosql/) against the
reference's (cosdata_tpu/cosql/): every statement of tests/test_cosql.py
parses to equal dicts in both packages, the multi-statement text to equal
lists, and each input the reference refuses raises ``ParseError`` in both,
with the same message."""

import pytest

from cosdata_tpu import cosql as J
from cosdata_tpu_torch import cosql as T

#: the statements of tests/test_cosql.py, in its order
STATEMENTS = [
    """define entity person as
                name: string,
                age: int,
                date_of_birth: date;""",
    "define relationship assigned_to as (project: project, assignee: person);",
    "define relationship employment as (employer: company, employee: person)"
    " as start_date: date, salary: double;",
    """define rule reachable_direct as
                match
                    (from: $city1, to: $city2) forms direct_flight
                infer
                    materialize (from: $city1, to: $city2) forms reachable;""",
    """insert $rust_dev isa person (
                name: "The Rust Dev",
                age: 54,
                date_of_birth: 01-01-1970
            );""",
    """insert $relation1 (
                project: $rust_project,
                assignee: $rust_dev
            ) forms assigned_to;""",
    """match
                $employee1 isa person ( name: $name1 ),
                $employee2 isa person ( name: $name2 ),
                $project isa project ( name: $project_name ),
                ($employee1, $project) forms assigned_to,
                ($employee2, $project) forms assigned_to,
                $employee1 != $employee2
            get $name1, $name2, $project_name;""",
    """match
                $item isa product ( cost_price: $cost_price,
                                    selling_price: $selling_price )
            compute
                $profit = $selling_price - $cost_price,
                $profit_percentage = ($profit / $cost_price) * 100
            get $profit_percentage;""",
    "match $x isa t compute $y = 1 + 2 * 3 ** 2 ** 2 get $y;",
    "match $p isa person ( age: $a ), $a > -1 get $p;",
    "match $p isa person ( score: $s ), $s < -2.5 get $p;",
    "insert $e isa person ( dob: 1-1-2024 );",
]

MULTI = """define entity city as name: string;
               insert $a isa city (name: "Paris");
               insert $b isa city (name: "Tokyo");"""

#: the inputs tests/test_cosql.py expects the parser to refuse
REFUSED = ["define entity as;", "define entity c as name: string; zzz"]


@pytest.mark.parametrize("text", STATEMENTS)
def test_statement_parses_as_in_the_reference(text):
    got = T.parse_statement(text)
    assert got == J.parse_statement(text)
    assert isinstance(got, dict) and got["kind"]


def test_statements_parse_as_in_the_reference():
    got = T.parse_statements(MULTI)
    assert got == J.parse_statements(MULTI)
    assert len(got) == 3
    assert T.parse_statements("\n".join(STATEMENTS)) == J.parse_statements("\n".join(STATEMENTS))


@pytest.mark.parametrize("text", REFUSED)
def test_refused_input_raises_in_both(text):
    with pytest.raises(J.ParseError) as want:
        J.parse_statement(text)
    with pytest.raises(T.ParseError) as got:
        T.parse_statement(text)
    assert str(got.value) == str(want.value)
    assert got.value.pos == want.value.pos
    assert "line" in str(got.value)
