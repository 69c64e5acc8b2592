"""A reader for the YAML of the experiment configs, without PyYAML.

The configs (``experiments/**/config*.yaml``) are nested block mappings of
scalars with comments. This reader takes exactly that subset and resolves
each scalar as PyYAML's ``safe_load`` does (YAML 1.1): ``true``/``yes``/``on``
and their negations are bools; ``null``, ``~`` and an empty value are None;
decimal integers (underscores allowed) are ints; a float needs a dot, and
an exponent needs its sign, so ``1.0e+7`` is a float while ``1e-5`` and
``1.0e7`` stay strings, as in PyYAML; ``.inf`` and ``.nan`` are floats.

Anything else raises ``ValueError`` naming the line: sequences, flow
collections, anchors, aliases, tags, block scalars, several documents, tabs,
duplicate keys, and the integer and date forms this reader does not
implement (octal, hex, binary, sexagesimal, timestamps). It never guesses.
"""

from __future__ import annotations

import re

_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = {"", "~", "null", "Null", "NULL"}
# PyYAML's implicit resolvers (resolver.py), the forms this reader builds
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
# the forms PyYAML resolves to something this reader does not build
_UNBUILT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*"
    r"|<<|=)$"
)
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_\-]*):(?:[ ](.*))?$")
_PLAIN = re.compile(r"^[A-Za-z0-9_.+\-/]+(?: [A-Za-z0-9_.+\-/]+)*$")


def _scalar(text: str, where: str):
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if len(text) >= 2 and text[0] == text[-1] == "'":
        body = text[1:-1]
        if "'" in body.replace("''", ""):
            raise ValueError(f"{where}: unbalanced single quotes in {text!r}")
        return body.replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        body = text[1:-1]
        if "\\" in body or '"' in body:
            raise ValueError(f"{where}: escapes in double quotes are outside the subset: {text!r}")
        return body
    if _UNBUILT.match(text):
        raise ValueError(f"{where}: the scalar {text!r} is a YAML form this reader does not build")
    if not _PLAIN.match(text) or text == "-" or text.startswith("- "):
        raise ValueError(f"{where}: {text!r} is outside the subset of plain scalars")
    if _DECIMAL.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        if value.endswith(".inf"):
            return float("-inf") if value.startswith("-") else float("inf")
        if value == ".nan":
            return float("nan")
        return float(value)
    return text


def _strip_comment(text: str) -> str:
    """The value without a trailing comment (`` #`` outside quotes)."""
    if text.startswith(("'", '"')):
        end = text.find(text[0], 1)
        while end != -1 and text[0] == "'" and text[end + 1 : end + 2] == "'":
            end = text.find("'", end + 2)  # '' inside single quotes is a quote
        if end == -1:
            return text  # unbalanced: _scalar raises
        rest = text[end + 1 :]
        if rest.strip() and not re.match(r"\s+#", rest):
            raise ValueError(f"text after a quoted scalar: {text!r}")
        return text[: end + 1]
    if text.startswith("#"):
        return ""
    cut = text.find(" #")
    return (text if cut == -1 else text[:cut]).rstrip()


def loads(text: str):
    """The mapping a config's YAML text describes (None for an empty
    document, as ``yaml.safe_load``)."""
    root: dict = {}
    # open mappings, innermost last: (indentation of their keys, mapping)
    stack: list[tuple[int, dict]] = [(0, root)]
    pending = None  # (indentation, mapping, key) of a key whose value may be a block
    seen_any = False
    for number, raw in enumerate(text.splitlines(), start=1):
        where = f"line {number}"
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in body[: len(body) - len(stripped) + 1]:
            raise ValueError(f"{where}: tabs in indentation")
        if stripped == "-" or stripped.startswith(
                ("---", "...", "%", "- ", "? ", "[", "{", "&", "*", "!", "|", ">")):
            raise ValueError(f"{where}: {stripped!r} is outside the subset (block mappings "
                             "of scalars)")
        indent = len(body) - len(stripped)
        seen_any = True
        if pending is not None:
            p_indent, p_map, p_key = pending
            if indent > p_indent:  # the pending key opens a block
                child: dict = {}
                p_map[p_key] = child
                stack.append((indent, child))
            else:
                p_map[p_key] = None
            pending = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise ValueError(f"{where}: indentation {indent} matches no open mapping")
        mapping = stack[-1][1]
        match = _KEY.match(stripped)
        if match is None:
            raise ValueError(f"{where}: {stripped!r} is not a 'key: value' line of the subset")
        key, value = match.group(1), match.group(2)
        if key in _BOOL or key in _NULL or _DECIMAL.match(key) or _FLOAT.match(key):
            raise ValueError(f"{where}: the key {key!r} would not be a string in YAML")
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        value = "" if value is None else _strip_comment(value.strip())
        if value == "":
            mapping[key] = None
            pending = (indent, mapping, key)
        else:
            mapping[key] = _scalar(value, where)
    if not seen_any:
        return None
    return root


def load_config(path: str):
    """The config at ``path`` (see :func:`loads`)."""
    with open(path) as f:
        return loads(f.read())
