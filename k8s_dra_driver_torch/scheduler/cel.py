"""The port of ``k8s_dra_driver_tpu/scheduler/cel.py`` (lines 1-498; copied: the port
imports nothing of the JAX package).

CEL-subset evaluator for DRA device selectors.

The upstream kube-scheduler evaluates DeviceClass and per-request CEL
selectors against published device attributes (SURVEY.md §3.5; reference
DeviceClass example: ``device.driver == 'gpu.nvidia.com' && ...`` in
deployments/helm/.../deviceclass-gpu.yaml).  This module implements the
subset of CEL those selectors actually use, so the in-repo allocator and the
demo harness can run the same expressions a real cluster would:

* literals: int, float, string (single/double quoted), bool, null, lists
* operators: ``|| && ! == != < <= > >= in + - * / %``, ternary ``?:``
* member access ``a.b``, indexing ``a['k']`` / ``a[0]``
* functions: ``size(x)``, ``x.matches(re)``, ``x.startsWith(s)``,
  ``x.endsWith(s)``, ``x.contains(s)``, ``quantity(s)`` (k8s resource
  quantity → integer base units, so capacity comparisons like
  ``device.capacity['d'].hbm >= quantity('16Gi')`` work — the allocator
  exposes capacities pre-parsed to integers for exactly this)

Evaluation errors (unknown identifier, missing map key) raise
:class:`CELError`; per CEL-in-k8s semantics the caller treats an erroring
selector as non-matching.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

__all__ = ["CELError", "evaluate", "compile_expr"]


class CELError(Exception):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<float>\d+\.\d+)
  | (?P<int>\d+)
  | (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\|\||&&|==|!=|<=|>=|[<>!+\-*/%?:.,\[\]()])
    """,
    re.VERBOSE,
)

_KEYWORDS = {"true": True, "false": False, "null": None}


@dataclass
class Token:
    kind: str  # 'int' | 'float' | 'string' | 'ident' | 'op' | 'end'
    value: Any


def _lex(src: str) -> list[Token]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise CELError(f"lex error at {src[pos:pos+10]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "int":
            out.append(Token("lit", int(text)))
        elif kind == "float":
            out.append(Token("lit", float(text)))
        elif kind == "string":
            body = text[1:-1]
            body = re.sub(r"\\(.)", r"\1", body)
            out.append(Token("lit", body))
        elif kind == "ident":
            if text in _KEYWORDS:
                out.append(Token("lit", _KEYWORDS[text]))
            else:
                out.append(Token("ident", text))
        else:
            out.append(Token("op", text))
    out.append(Token("end", None))
    return out


# ---------------------------------------------------------------------------
# Pratt parser → nested tuples (op, args...)
# ---------------------------------------------------------------------------

_BINARY_PRECEDENCE = {
    "||": 1,
    "&&": 2,
    "==": 3, "!=": 3, "<": 3, "<=": 3, ">": 3, ">=": 3, "in": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5,
}

_TERNARY_PRECEDENCE = 0.5


class _Parser:
    def __init__(self, tokens: list[Token]):
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Token:
        return self.tokens[self.pos]

    def next(self) -> Token:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def expect(self, value: str) -> None:
        tok = self.next()
        if tok.kind != "op" or tok.value != value:
            raise CELError(f"expected {value!r}, got {tok.value!r}")

    def parse(self):
        expr = self.parse_expr(0)
        if self.peek().kind != "end":
            raise CELError(f"trailing input at {self.peek().value!r}")
        return expr

    def parse_expr(self, min_prec):
        left = self.parse_unary()
        while True:
            tok = self.peek()
            op = tok.value if tok.kind == "op" else ("in" if (tok.kind, tok.value) == ("ident", "in") else None)
            if op == "?" and _TERNARY_PRECEDENCE >= min_prec:
                self.next()
                then = self.parse_expr(0)
                self.expect(":")
                otherwise = self.parse_expr(_TERNARY_PRECEDENCE)
                left = ("?:", left, then, otherwise)
                continue
            prec = _BINARY_PRECEDENCE.get(op)
            if prec is None or prec < min_prec:
                return left
            self.next()
            right = self.parse_expr(prec + 1)
            left = (op, left, right)

    def parse_unary(self):
        tok = self.peek()
        if tok.kind == "op" and tok.value == "!":
            self.next()
            return ("!", self.parse_unary())
        if tok.kind == "op" and tok.value == "-":
            self.next()
            return ("neg", self.parse_unary())
        return self.parse_postfix(self.parse_primary())

    def parse_primary(self):
        tok = self.next()
        if tok.kind == "lit":
            return ("lit", tok.value)
        if tok.kind == "ident":
            return ("var", tok.value)
        if tok.kind == "op" and tok.value == "(":
            inner = self.parse_expr(0)
            self.expect(")")
            return inner
        if tok.kind == "op" and tok.value == "[":
            items = []
            if not (self.peek().kind == "op" and self.peek().value == "]"):
                while True:
                    items.append(self.parse_expr(0))
                    if self.peek().kind == "op" and self.peek().value == ",":
                        self.next()
                        continue
                    break
            self.expect("]")
            return ("list", items)
        raise CELError(f"unexpected token {tok.value!r}")

    def parse_postfix(self, expr):
        while True:
            tok = self.peek()
            if tok.kind == "op" and tok.value == ".":
                self.next()
                name = self.next()
                if name.kind != "ident":
                    raise CELError(f"expected member name, got {name.value!r}")
                if self.peek().kind == "op" and self.peek().value == "(":
                    self.next()
                    args = []
                    if not (self.peek().kind == "op" and self.peek().value == ")"):
                        while True:
                            args.append(self.parse_expr(0))
                            if self.peek().kind == "op" and self.peek().value == ",":
                                self.next()
                                continue
                            break
                    self.expect(")")
                    expr = ("call", name.value, expr, args)
                else:
                    expr = ("member", expr, name.value)
            elif tok.kind == "op" and tok.value == "[":
                self.next()
                index = self.parse_expr(0)
                self.expect("]")
                expr = ("index", expr, index)
            elif tok.kind == "op" and tok.value == "(":
                # bare function call — only size() is global
                if expr[0] != "var":
                    raise CELError("only simple function calls supported")
                self.next()
                args = []
                if not (self.peek().kind == "op" and self.peek().value == ")"):
                    while True:
                        args.append(self.parse_expr(0))
                        if self.peek().kind == "op" and self.peek().value == ",":
                            self.next()
                            continue
                        break
                self.expect(")")
                expr = ("call", expr[1], None, args)
            else:
                return expr


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


class AttrBag(dict):
    """Dict allowing CEL member access (``bag.type``)."""


def _eval(node, env):
    op = node[0]
    if op == "lit":
        return node[1]
    if op == "var":
        if node[1] not in env:
            raise CELError(f"unknown identifier {node[1]!r}")
        return env[node[1]]
    if op == "list":
        return [_eval(x, env) for x in node[1]]
    if op == "!":
        return not _truthy(_eval(node[1], env))
    if op == "neg":
        try:
            return -_eval(node[1], env)
        except TypeError as exc:
            # Same CELError conversion the binary arithmetic ops get: a
            # type mismatch is a non-matching selector, not a crash.
            raise CELError(f"cannot negate: {exc}") from exc
    if op == "||":
        return _truthy(_eval(node[1], env)) or _truthy(_eval(node[2], env))
    if op == "&&":
        return _truthy(_eval(node[1], env)) and _truthy(_eval(node[2], env))
    if op == "?:":
        return _eval(node[2] if _truthy(_eval(node[1], env)) else node[3], env)
    if op == "member":
        obj = _eval(node[1], env)
        return _get(obj, node[2])
    if op == "index":
        obj = _eval(node[1], env)
        key = _eval(node[2], env)
        return _get(obj, key)
    if op == "call":
        return _call(node[1], node[2], [_eval(a, env) for a in node[3]], env)
    if op == "in":
        item = _eval(node[1], env)
        container = _eval(node[2], env)
        try:
            return item in container
        except TypeError as exc:
            raise CELError(f"'in' needs a list/map/string container: {exc}") from exc
    left = _eval(node[1], env)
    right = _eval(node[2], env)
    if op == "==":
        return left == right
    if op == "!=":
        return left != right
    try:
        if op == "<":
            return left < right
        if op == "<=":
            return left <= right
        if op == ">":
            return left > right
        if op == ">=":
            return left >= right
        if op == "+":
            return left + right
        if op == "-":
            return left - right
        if op == "*":
            return left * right
        if op == "/":
            return left // right if isinstance(left, int) and isinstance(right, int) else left / right
        if op == "%":
            # CEL % is numeric-only; Python would silently %-format a
            # string left operand (or raise ValueError on a bad format).
            if isinstance(left, str) or isinstance(right, str):
                raise CELError("% requires numeric operands")
            return left % right
    except (TypeError, ZeroDivisionError) as exc:
        # CEL-in-k8s semantics: an evaluation error (type mismatch, division
        # by zero) makes the selector a non-match, never a crash.
        raise CELError(str(exc)) from exc
    raise CELError(f"unsupported operator {op!r}")


def _truthy(v) -> bool:
    if not isinstance(v, bool):
        raise CELError(f"expected bool, got {type(v).__name__}")
    return v


def _get(obj, key):
    if isinstance(obj, dict):
        if key not in obj:
            raise CELError(f"no such key: {key!r}")
        return obj[key]
    if isinstance(obj, (list, str)) and isinstance(key, int):
        try:
            return obj[key]
        except IndexError as exc:
            raise CELError(str(exc)) from exc
    raise CELError(f"cannot index {type(obj).__name__} with {key!r}")


def _call(name, recv_node, args, env):
    recv = _eval(recv_node, env) if recv_node is not None else None
    if name == "size":
        if recv is None and len(args) != 1:
            raise CELError(f"size() takes exactly one argument, got {len(args)}")
        target = args[0] if recv is None else recv
        if not isinstance(target, (str, list, dict)):
            raise CELError(f"size() argument must be sized, got {type(target).__name__}")
        return len(target)
    if name == "quantity" and recv is None:
        from k8s_dra_driver_torch.kube import quantity as q

        if (
            len(args) != 1
            or isinstance(args[0], bool)  # no bool->int coercion in CEL
            or not isinstance(args[0], (str, int))
        ):
            raise CELError(f"quantity() takes one string/int argument, got {args!r}")
        try:
            return q.parse(args[0])
        except q.InvalidQuantity as exc:
            raise CELError(str(exc)) from exc
    if recv is None:
        raise CELError(f"unknown function {name!r}")
    if not isinstance(recv, str):
        raise CELError(f"{name}() receiver must be string")
    if len(args) != 1:
        raise CELError(f"{name}() takes exactly one argument, got {len(args)}")
    (arg,) = args
    if name == "matches":
        if not isinstance(arg, str):
            raise CELError("matches() argument must be string")
        _guard_regex(arg)
        try:
            return re.search(arg, recv) is not None
        except re.error as exc:
            raise CELError(f"bad regex: {exc}") from exc
    if name == "startsWith":
        return recv.startswith(arg)
    if name == "endsWith":
        return recv.endswith(arg)
    if name == "contains":
        return arg in recv
    raise CELError(f"unknown method {name!r}")


_MAX_REGEX_LEN = 256


def _guard_regex(pattern: str) -> None:
    """Reject patterns that can backtrack catastrophically.

    Real CEL mandates RE2 (linear time); Python's ``re`` backtracks, so a
    user-authored selector like ``(a+)+b`` or ``(a|a)+$`` could hang
    allocation for every claim.  Conservative static screen: a quantifier
    applied to a group whose body contains a quantifier OR an alternation
    (the two classic exponential shapes) is rejected, as are oversized
    patterns.  Character classes are skipped (literal ``+`` inside
    ``[...]`` is not a quantifier).  Legitimate device selectors
    (``v5e|v6e``, ``tpu-.*``, ``[0-9+]+`` , anchored literals) pass;
    quantified alternation groups like ``(ab|cd)+`` are rejected — a
    price of not having RE2."""
    if len(pattern) > _MAX_REGEX_LEN:
        raise CELError(f"regex longer than {_MAX_REGEX_LEN} chars")
    # per open group: does its body contain a quantifier or alternation?
    depth_danger: list[bool] = [False]
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            i += 2
            continue
        if c == "[":
            # skip the character class: ']' is literal when first (possibly
            # after '^'), escapes respected
            j = i + 1
            if j < len(pattern) and pattern[j] == "^":
                j += 1
            if j < len(pattern) and pattern[j] == "]":
                j += 1
            while j < len(pattern) and pattern[j] != "]":
                j += 2 if pattern[j] == "\\" else 1
            i = j + 1
            continue
        if c == "(":
            depth_danger.append(False)
        elif c == ")":
            inner = depth_danger.pop() if len(depth_danger) > 1 else False
            if inner and i + 1 < len(pattern) and pattern[i + 1] in "*+{":
                raise CELError(
                    "regex rejected: quantified group containing a quantifier "
                    "or alternation (catastrophic backtracking risk; CEL "
                    "proper uses RE2)"
                )
            # a dangerous group makes the ENCLOSING group dangerous too
            if inner and depth_danger:
                depth_danger[-1] = True
        elif (
            c in "*+{|"
            or (c == "?" and i > 0 and pattern[i - 1] not in "(*+{?")
        ):
            depth_danger[-1] = True
        i += 1


class CompiledExpr:
    def __init__(self, src: str):
        self.src = src
        try:
            self.ast = _Parser(_lex(src)).parse()
        except RecursionError as exc:
            # A pathologically nested user expression must not blow the
            # interpreter stack out of the allocator (fuzz finding).
            raise CELError("expression too deeply nested") from exc

    def evaluate(self, env: dict[str, Any]) -> Any:
        """The only-CELError boundary.

        Callers (allocator._matches_selectors) treat CELError as
        "selector does not match" and anything else as a crash — so EVERY
        runtime error converts here, not just the types we have met so
        far: patching leak classes one exception at a time (TypeError,
        then ZeroDivisionError, then ValueError from str %, then
        unhashable-key TypeError...) was whack-a-mole; a user-authored
        expression must never take down allocation."""
        try:
            return _eval(self.ast, env)
        except CELError:
            raise
        except RecursionError as exc:
            raise CELError("expression too deeply nested") from exc
        except Exception as exc:
            raise CELError(f"evaluation error: {type(exc).__name__}: {exc}") from exc


# Compile cache: bounded LRU.  Selector strings are user-authored (claim
# specs) — an unbounded dict would let adversarial or generated selectors
# grow allocator memory without limit.  1024 entries comfortably covers a
# cluster's distinct DeviceClass + request selectors while capping worst
# case at ~1k parsed ASTs.
_CACHE_CAPACITY = 1024
_cache: "OrderedDict[str, CompiledExpr]" = OrderedDict()
_cache_lock = threading.Lock()


def compile_expr(src: str) -> CompiledExpr:
    with _cache_lock:
        compiled = _cache.get(src)
        if compiled is not None:
            _cache.move_to_end(src)
            return compiled
    compiled = CompiledExpr(src)  # parse outside the lock: may raise CELError
    with _cache_lock:
        _cache[src] = compiled
        _cache.move_to_end(src)
        while len(_cache) > _CACHE_CAPACITY:
            _cache.popitem(last=False)
    return compiled


def evaluate(src: str, env: dict[str, Any]) -> Any:
    return compile_expr(src).evaluate(env)
