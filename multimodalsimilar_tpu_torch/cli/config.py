"""The ``--config`` file reader: the subset of YAML that ``configs/*.yaml``
use, read without PyYAML (the card machine has none).

A config is one mapping of top-level ``key: value`` lines. Accepted:

* ``#`` comment lines, blank lines and trailing `` # comments``;
* scalars, bare or quoted ('single', with ``''`` for a quote, or
  "double", with backslash escapes);
* lists, as a flow list (``key: [48, 64]``) or a block list (``key:``
  followed by ``- item`` lines, indented or not).

Bare scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1):
``null``/``~``/nothing is None, ``true``/``yes``/``on`` and their
``false`` forms are bools, ints take ``0x``/``0b``/leading-zero octal,
``_`` separators and base-60 ``1:30``, floats need a dot (``5.0e-5`` is a
float, ``1e5`` a string) or are ``.inf``/``.nan``, ``YYYY-MM-DD`` is a
``datetime.date``; anything else (``127.0.0.1``, ``48,64,96``) stays a
string. A duplicate key keeps its last value, as PyYAML does.

Everything else (nested mappings, multi-line scalars, anchors, tags,
flow mappings, block scalars, timestamps with a time) raises
``ConfigError`` naming the file and line, instead of being misread.
"""

from __future__ import annotations

import datetime
import re
from typing import Any, Dict, List, Tuple

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)[ \t]*:(?:[ \t]+(.*))?$")
_ITEM = re.compile(r"^([ ]*)-(?:[ \t]+(.*))?$")

# PyYAML's implicit resolvers (yaml/resolver.py), with its constructors
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_DATE = re.compile(r"^([0-9]{4})-([0-9]{2})-([0-9]{2})$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)"
                        r"[0-9]{1,2}:[0-9]{2}:[0-9]{2}")
# characters a plain scalar cannot start with (the YAML indicators; '-',
# '?' and ':' only when a space or nothing follows)
_INDICATORS = set("#,[]{}&*!|>'\"%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


class ConfigError(ValueError):
    """A config line outside the supported subset, or malformed."""


def _sign(text: str) -> Tuple[int, str]:
    if text[:1] in "+-":
        return (-1 if text[0] == "-" else 1), text[1:]
    return 1, text


def _base60(text: str) -> float:
    value = 0
    for part in text.split(":"):
        value = value * 60 + float(part)
    return value


def _int(text: str) -> int:
    sign, text = _sign(text.replace("_", ""))
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if ":" in text:
        return sign * int(_base60(text))
    if text.startswith("0"):
        return sign * int(text, 8)
    return sign * int(text)


def _float(text: str) -> float:
    sign, text = _sign(text.replace("_", "").lower())
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _base60(text)
    return sign * float(text)


class _Line:
    def __init__(self, source: str, number: int):
        self.source, self.number = source, number

    def error(self, what: str) -> ConfigError:
        return ConfigError(f"{self.source}:{self.number}: {what}")


def _plain(text: str, line: _Line) -> Any:
    """A bare scalar, resolved as PyYAML's safe_load resolves it."""
    if text in _NULL:
        return None
    if text[0] in _INDICATORS or (text[0] in "-?:" and len(text) > 1
                                  and text[1] in " \t") or text in "-?:":
        raise line.error(f"unsupported YAML syntax {text!r} (only flat "
                         "scalars and lists are read)")
    if ": " in text or ":\t" in text or text.endswith(":"):
        raise line.error(f"unsupported YAML syntax {text!r} (a nested "
                         "mapping or an ambiguous scalar)")
    if text in ("<<", "="):
        raise line.error(f"unsupported YAML scalar {text!r}")
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    date = _DATE.match(text)
    if date:
        try:
            return datetime.date(*map(int, date.groups()))
        except ValueError as e:
            raise line.error(f"{text!r}: {e}") from None
    if _TIMESTAMP.match(text):
        raise line.error(f"timestamps with a time are not read: {text!r}")
    return text


def _double_quoted(body: str, line: _Line) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        esc = body[i + 1: i + 2]
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            i += 2
        elif esc in _HEX:
            width = _HEX[esc]
            digits = body[i + 2: i + 2 + width]
            if not re.fullmatch(f"[0-9a-fA-F]{{{width}}}", digits):
                raise line.error(f"bad escape \\{esc}{digits}")
            out.append(chr(int(digits, 16)))
            i += 2 + width
        else:
            raise line.error(f"unknown escape \\{esc}")
    return "".join(out)


def _quoted(text: str, line: _Line) -> Tuple[str, str]:
    """(the quoted scalar at the start of ``text``, the rest)."""
    q = text[0]
    i = 1
    while i < len(text):
        if text[i] == q:
            if q == "'" and text[i + 1: i + 2] == "'":
                i += 2
                continue
            body = text[1:i]
            value = (body.replace("''", "'") if q == "'"
                     else _double_quoted(body, line))
            return value, text[i + 1:]
        i += 2 if (q == '"' and text[i] == "\\") else 1
    raise line.error("unterminated quoted scalar (multi-line scalars are "
                     "not read)")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment: '#' at its start or after
    whitespace."""
    for i, ch in enumerate(text):
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _after_quote(rest: str, line: _Line) -> None:
    if _strip_comment(rest).strip():
        raise line.error(f"unexpected text after a quoted scalar: "
                         f"{rest.strip()!r}")


def _flow_list(text: str, line: _Line) -> List[Any]:
    items: List[Any] = []
    rest = text[1:].lstrip()
    while True:
        if rest.startswith("]"):
            if _strip_comment(rest[1:]).strip():
                raise line.error("unexpected text after a flow list")
            return items
        if rest[:1] in ("'", '"'):
            value, rest = _quoted(rest, line)
            rest = rest.lstrip()
        else:
            m = re.match(r"[^,\]]*", rest)
            token = m.group(0).strip()
            if not token or token[0] in "[{":
                raise line.error("nested or empty flow list items are not "
                                 "read (flow lists of scalars only)")
            if "#" in token:
                raise line.error("comments inside a flow list are not read")
            value = _plain(token, line)
            rest = rest[m.end():]
        items.append(value)
        if rest.startswith(","):
            rest = rest[1:].lstrip()
            if rest.startswith("]"):
                raise line.error("trailing comma in a flow list")
        elif not rest.startswith("]"):
            raise line.error("unterminated flow list (one line only)")


def _value(text: str, line: _Line) -> Any:
    """A value on a key's or a list item's line ('' when none)."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, line)
        _after_quote(rest, line)
        return value
    text = _strip_comment(text)
    if text.startswith("["):
        return _flow_list(text, line)
    if text.startswith("{"):
        raise line.error("flow mappings are not read (flat keys only)")
    return _plain(text, line)


def parse_config(text: str, source: str = "<config>") -> Dict[str, Any]:
    """The mapping of a config's text; ``source`` names it in errors."""
    lines = text.split("\n")
    if lines and lines[0].startswith("\ufeff"):
        lines[0] = lines[0][1:]
    out: Dict[str, Any] = {}
    open_key = None          # a 'key:' with no value, awaiting '- ' items
    for number, raw in enumerate(lines, 1):
        line = _Line(source, number)
        raw = raw.rstrip("\r")
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise line.error("tab indentation")
        item = _ITEM.match(raw)
        if item:
            if open_key is None:
                raise line.error("a list item outside a key's block list "
                                 "(the config must be one flat mapping)")
            value = _value(item.group(2) or "", line)
            if isinstance(value, list):
                raise line.error("nested lists are not read")
            if not isinstance(out[open_key], list):
                out[open_key] = []
            out[open_key].append(value)
            continue
        if raw[0] in " \t":
            raise line.error("indented line: nested mappings and "
                             "multi-line scalars are not read")
        if body in ("---", "...") or body.startswith(("--- ", "%")):
            raise line.error("YAML documents and directives are not read")
        m = _KEY.match(_strip_comment(raw)) if raw[0] not in "'\"" else None
        if not m:
            raise line.error(f"expected 'key: value', got {body!r}")
        key = m.group(1)
        if key in _BOOL or key in _NULL:
            raise line.error(f"key {key!r} reads as a bool or null in YAML")
        rest = raw[raw.index(":") + 1:]
        out[key] = _value(rest, line)
        open_key = key if not _strip_comment(rest).strip() else None
    return out


def load_config(path: str) -> Dict[str, Any]:
    """The mapping in the config file at ``path`` ({} when it is empty)."""
    with open(path, encoding="utf-8") as f:
        return parse_config(f.read(), path)
