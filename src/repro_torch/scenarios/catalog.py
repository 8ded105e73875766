"""Declarative YAML scenario catalog (port of ``repro/scenarios/catalog.py``).

``scenarios/catalog/*.yaml`` names workloads once, so regression suites,
benchmarks and sweeps reference them by name:

.. code-block:: yaml

    name: metro_daily
    description: city fleet with a day cycle and commuter churn
    base:   {kind: bursty_counter, T: 2000, N: 16, seed: 3}
    modifiers:
      - {kind: diurnal, extra: {period: 500, amp: 0.7}}
      - {kind: churn,   extra: {churn_frac: 0.25}}

``base`` is any registered scenario kind; ``modifiers`` (optional) apply in
order through ``spec.compose``.  Modifier entries inherit the base's (T,
N, seed) unless they set them.

The files are read by :func:`parse_yaml`, a reader of the YAML subset the
catalog uses (block mappings and sequences, flow mappings, int / float /
string scalars, ``#`` comments), which gives what ``yaml.safe_load`` gives
for such a document and raises on anything outside the subset; the port
needs no YAML package.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Union

from repro_torch.scenarios.spec import CompiledScenario, Scenario, compose

# YAML 1.1's plain-scalar forms as safe_load resolves them: the int and
# float forms the subset takes, and the forms it refuses (other ints,
# special floats, booleans, null, timestamps, merge / value keys)
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_REFUSED = re.compile(
    r"(?:[-+]?0[0-7_]+|[-+]?0[bx][0-9a-fA-F_]+|[-+]?[0-9][0-9_]*(?::[0-9_]+)+"
    r"|[-+]?[0-9][0-9_]*\.?[0-9_]*(?:[eE][-+]?[0-9]+)?|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN)|yes|Yes|YES|no|No|NO|true|True|TRUE|false"
    r"|False|FALSE|on|On|ON|off|Off|OFF|~|null|Null|NULL|<<|="
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)$")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")
_INDICATORS = set("&*!|>%@`'\"[]{},?:-#")


class CatalogSyntaxError(ValueError):
    """A catalog document outside the YAML subset the reader takes."""


def _scalar(text: str, where: str):
    """A plain scalar as safe_load resolves it: int, float or str."""
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if (not text or _REFUSED.match(text) or text[0] in _INDICATORS
            or ": " in text or " #" in text or text.endswith(":")):
        raise CatalogSyntaxError(f"{where}: {text!r} is not an int, float "
                                 "or plain string scalar")
    return text


def _flow(text: str, where: str) -> dict:
    """A whole flow mapping ``{k: v, ...}`` (values: scalars or nested
    flow mappings)."""
    pos = 0

    def ws():
        nonlocal pos
        while pos < len(text) and text[pos] == " ":
            pos += 1

    def mapping():
        nonlocal pos
        pos += 1  # "{"
        out = {}
        ws()
        if pos < len(text) and text[pos] == "}":
            pos += 1
            return out
        while True:
            ws()
            m = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*:\s").match(text, pos)
            if m is None:
                raise CatalogSyntaxError(f"{where}: expected 'key: ' at "
                                         f"{text[pos:]!r}")
            key, pos = m.group(1), m.end()
            ws()
            if pos < len(text) and text[pos] == "{":
                value = mapping()
            else:
                end = pos
                while end < len(text) and text[end] not in ",}":
                    end += 1
                value = _scalar(text[pos:end].strip(), where)
                pos = end
            if key in out:
                raise CatalogSyntaxError(f"{where}: duplicate key {key!r}")
            out[key] = value
            ws()
            if pos < len(text) and text[pos] == ",":
                pos += 1
                continue
            if pos < len(text) and text[pos] == "}":
                pos += 1
                return out
            raise CatalogSyntaxError(f"{where}: unterminated flow mapping "
                                     f"{text!r}")

    if not text.startswith("{"):
        raise CatalogSyntaxError(f"{where}: not a flow mapping: {text!r}")
    out = mapping()
    if text[pos:].strip():
        raise CatalogSyntaxError(f"{where}: text after the flow mapping: "
                                 f"{text[pos:]!r}")
    return out


def _lines(text: str):
    """(line number, indent, content) of every line with content, comments
    stripped; refuses tabs, directives and document markers."""
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        line = raw
        for i, ch in enumerate(raw):  # a comment: '#' at the start or
            if ch == "#" and (i == 0 or raw[i - 1] in " \t"):  # after blank
                line = raw[:i]
                break
        line = line.rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or line.startswith(("%", "---", "...")):
            raise CatalogSyntaxError(f"line {no}: tabs, directives and "
                                     "document markers are outside the "
                                     "subset")
        out.append((no, len(line) - len(body), body))
    return out


def _value(rest: str, lines, i: int, indent: int, where: str):
    """The value after ``key:`` / ``- ``: inline, else the block below."""
    if rest.startswith("{"):
        return _flow(rest, where), i
    if rest:
        return _scalar(rest, where), i
    if i < len(lines) and (lines[i][1] > indent or (
            lines[i][1] == indent and lines[i][2].startswith("- "))):
        return _block(lines, i, lines[i][1])
    raise CatalogSyntaxError(f"{where}: an empty value (null) is outside "
                             "the subset")


def _entry(body: str, where: str):
    """(key, rest) of a ``key: value`` / ``key:`` line, or None."""
    m = re.match(r"([^:\s][^:]*?):(?:\s+(.*))?$", body)
    if m is None:
        return None
    if not _KEY.match(m.group(1)):
        raise CatalogSyntaxError(f"{where}: key {m.group(1)!r} is outside "
                                 "the subset")
    return m.group(1), (m.group(2) or "").strip()


def _block(lines, i: int, indent: int):
    """The block mapping or sequence starting at lines[i] (at ``indent``);
    returns (value, index of the first line after it)."""
    if lines[i][2].startswith("- ") or lines[i][2] == "-":
        out = []
        while i < len(lines) and lines[i][1] == indent and (
                lines[i][2].startswith("- ") or lines[i][2] == "-"):
            no, _, body = lines[i]
            rest = body[1:].lstrip(" ")
            inner = indent + len(body) - len(rest)
            where = f"line {no}"
            if rest and not rest.startswith("{") and _entry(rest, where):
                # a block mapping whose first key sits on the dash line
                item, i = _mapping(lines, i, inner, first=rest)
            else:
                item, i = _value(rest, lines, i + 1, indent, where)
            out.append(item)
        return out, i
    return _mapping(lines, i, indent)


def _mapping(lines, i: int, indent: int, first: Optional[str] = None):
    out = {}
    while i < len(lines):
        no, ind, body = lines[i]
        if first is not None:
            body, first = first, None
        elif ind != indent:
            break
        where = f"line {no}"
        kv = _entry(body, where)
        if kv is None:
            raise CatalogSyntaxError(f"{where}: expected 'key: value', got "
                                     f"{body!r}")
        key, rest = kv
        if key in out:
            raise CatalogSyntaxError(f"{where}: duplicate key {key!r}")
        out[key], i = _value(rest, lines, i + 1, indent, where)
    if i < len(lines) and lines[i][1] > indent:
        raise CatalogSyntaxError(f"line {lines[i][0]}: unexpected indent")
    return out, i


def parse_yaml(text: str):
    """Parse a catalog document in the YAML subset above (what
    ``yaml.safe_load`` gives for it); raise :class:`CatalogSyntaxError` on
    anything outside it."""
    lines = _lines(text)
    if not lines:
        raise CatalogSyntaxError("an empty document is outside the subset")
    if lines[0][1] != 0:
        raise CatalogSyntaxError(f"line {lines[0][0]}: the document must "
                                 "start at column 0")
    no, _, body = lines[0]
    if body.startswith("{"):
        if len(lines) > 1:
            raise CatalogSyntaxError(f"line {lines[1][0]}: text after the "
                                     "flow mapping")
        return _flow(body, f"line {no}")
    value, i = _block(lines, 0, 0)
    if i < len(lines):
        raise CatalogSyntaxError(f"line {lines[i][0]}: text outside the "
                                 "document's block")
    return value


def catalog_dir() -> Path:
    """The packaged catalog directory (``repro_torch/scenarios/catalog``)."""
    return Path(__file__).resolve().parent / "catalog"


@dataclasses.dataclass(frozen=True)
class CatalogEntry:
    """A named workload: base spec + ordered modifier chain."""

    name: str
    base: Scenario
    modifiers: tuple = ()
    description: str = ""

    def compile(self, *, device=None) -> CompiledScenario:
        """The entry compiled on ``device`` (None -> cuda)."""
        from repro_torch.scenarios.registry import compile_scenario
        compiled = compile_scenario(self.base, device=device)
        for mod in self.modifiers:
            compiled = compose(compiled, mod)
        return compiled


def _spec_from_dict(d: dict, inherit: Optional[Scenario] = None) -> Scenario:
    d = dict(d)
    if "kind" not in d:
        raise ValueError(f"scenario entry missing 'kind': {d!r}")
    if inherit is not None:
        for field in ("T", "N", "seed"):
            d.setdefault(field, getattr(inherit, field))
    extra = d.pop("extra", {})
    sc = Scenario(**d)
    return sc.with_extra(**extra) if extra else sc


def parse_entry(doc: dict, name: Optional[str] = None) -> CatalogEntry:
    """Build a :class:`CatalogEntry` from one parsed document."""
    if not isinstance(doc, dict) or "base" not in doc:
        raise ValueError(f"catalog entry must be a mapping with a 'base' "
                         f"spec, got: {doc!r}")
    base = _spec_from_dict(doc["base"])
    mods = tuple(_spec_from_dict(m, inherit=base)
                 for m in doc.get("modifiers", []) or [])
    return CatalogEntry(name=doc.get("name", name or "unnamed"),
                        base=base, modifiers=mods,
                        description=doc.get("description", ""))


def load_entry(path: Union[str, Path]) -> CatalogEntry:
    """Load one ``*.yaml`` catalog file."""
    path = Path(path)
    return parse_entry(parse_yaml(path.read_text()), name=path.stem)


def load_catalog(path: Optional[Union[str, Path]] = None
                 ) -> Dict[str, CatalogEntry]:
    """Every entry of a catalog directory (default: the packaged one),
    keyed by entry name."""
    path = Path(path) if path is not None else catalog_dir()
    out: Dict[str, CatalogEntry] = {}
    for f in sorted(path.glob("*.yaml")):
        e = load_entry(f)
        if e.name in out:
            raise ValueError(f"duplicate catalog entry name {e.name!r}")
        out[e.name] = e
    return out


def catalog_names() -> List[str]:
    return sorted(load_catalog())


def compile_named(name: str, path: Optional[Union[str, Path]] = None, *,
                  device=None) -> CompiledScenario:
    """Compile a catalog entry by name on ``device`` (None -> cuda)."""
    cat = load_catalog(path)
    if name not in cat:
        raise KeyError(f"unknown catalog scenario {name!r}; "
                       f"available: {sorted(cat)}")
    return cat[name].compile(device=device)
