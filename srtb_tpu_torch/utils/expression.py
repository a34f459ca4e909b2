"""Arithmetic expression evaluation for config values.

The reference accepts arithmetic expressions in config values, e.g.
``baseband_input_count = 2 ** 30`` or ``baseband_freq_low = 1405 + (64/2)``
(ref: program_options.hpp:197-214 via 3rdparty/exprgrammar).  Here the same
capability is provided with a restricted AST walker over Python syntax, which
is a superset of the reference grammar (+ - * / % ** and parentheses).
"""

from __future__ import annotations

import ast
import operator

_BIN_OPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
    ast.BitXor: operator.pow,  # some radio configs write 2^30 meaning 2**30
    ast.LShift: operator.lshift,
    ast.RShift: operator.rshift,
}

_UNARY_OPS = {
    ast.UAdd: operator.pos,
    ast.USub: operator.neg,
}


def _eval_node(node: ast.AST):
    if isinstance(node, ast.Expression):
        return _eval_node(node.body)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float)):
            return node.value
        raise ValueError(f"non-numeric constant {node.value!r}")
    if isinstance(node, ast.BinOp):
        op_type = type(node.op)
        if op_type not in _BIN_OPS:
            raise ValueError(f"unsupported operator {op_type.__name__}")
        return _BIN_OPS[op_type](_eval_node(node.left), _eval_node(node.right))
    if isinstance(node, ast.UnaryOp):
        op_type = type(node.op)
        if op_type not in _UNARY_OPS:
            raise ValueError(f"unsupported unary operator {op_type.__name__}")
        return _UNARY_OPS[op_type](_eval_node(node.operand))
    raise ValueError(f"unsupported syntax {type(node).__name__}")


def parse_expression(text: str) -> float:
    """Evaluate an arithmetic config expression such as ``"2 ** 30"``.

    Returns a float or int; raises ValueError on anything that is not pure
    arithmetic.
    """
    tree = ast.parse(text.strip(), mode="eval")
    return _eval_node(tree)


def parse_number(text: str) -> float:
    """Parse a config value that may be a plain number or an expression."""
    try:
        return float(text)
    except ValueError:
        return float(parse_expression(text))
