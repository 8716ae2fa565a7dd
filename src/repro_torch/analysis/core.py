"""reprolint core, the port's own copy of ``repro.analysis.core``: files,
findings, suppressions, reporters.

The lint engine is deliberately small: a :class:`Project` parses every
``.py`` file under the given paths once, each :class:`Rule` walks the
shared ASTs and yields :class:`Finding`s, and suppression comments are
applied at the end so a rule never needs to know about them.

Suppressions are the pragma::

    x = thing.item()  # reprolint: disable=host-sync-in-hot-path -- <why>

The reason string after ``--`` (or an em-dash, or ``:``) is REQUIRED —
a bare disable is itself reported as ``bad-suppression`` and cannot be
suppressed.  A pragma on its own line covers the next line instead, so
annotations survive ``black``-style reflow of long statements.

The port's tree is linted by both linters (the reference's runs over all
of ``src/`` and ``tests/``), so the grammar is the reference's and the
port's rules carry the ids of the seven reference rules they stand in
for: one pragma parses, and suppresses, under both.  A pragma naming any
other id is a ``bad-suppression`` here as there.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: rule id used for malformed pragmas; never suppressible.
BAD_SUPPRESSION = "bad-suppression"
#: rule id used for files the parser rejects.
PARSE_ERROR = "parse-error"

_PRAGMA_RE = re.compile(r"#\s*reprolint:\s*disable=([A-Za-z0-9_,-]+)(.*)$")
_REASON_SEP_RE = re.compile(r"^\s*(?:--|—|:)\s*")
_HOT_PATH_RE = re.compile(r"#\s*reprolint:\s*hot-path\b")


@dataclass(frozen=True, order=True)
class Finding:
    """One lint finding, sortable into report order."""
    path: str
    line: int
    col: int
    rule: str
    message: str

    def as_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "rule": self.rule, "message": self.message}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}: {self.message}")


@dataclass
class Suppression:
    line: int            # line the pragma sits on
    rules: Set[str]
    reason: str
    own_line: bool       # pragma is the whole (stripped) line


@dataclass
class SourceFile:
    path: str                    # absolute
    rel: str                     # repo/project-relative, '/'-separated
    text: str
    tree: Optional[ast.AST]
    suppressions: List[Suppression] = field(default_factory=list)
    hot_path_lines: Set[int] = field(default_factory=set)
    parse_findings: List[Finding] = field(default_factory=list)

    @property
    def lines(self) -> List[str]:
        return self.text.splitlines()

    def suppressed_rules_for(self, line: int) -> Set[str]:
        out: Set[str] = set()
        for s in self.suppressions:
            if not s.reason:
                continue             # malformed: never suppresses
            if s.line == line or (s.own_line and s.line + 1 == line):
                out |= s.rules
        return out


def _scan_pragmas(f: SourceFile, known_rules: Set[str]) -> None:
    """Collect disable pragmas + hot-path markers via the tokenizer (so
    pragma-looking text inside string literals is ignored)."""
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(f.text).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        line_no = tok.start[0]
        if _HOT_PATH_RE.search(tok.string):
            f.hot_path_lines.add(line_no)
            continue
        m = _PRAGMA_RE.search(tok.string)
        if m is None:
            if "reprolint" in tok.string:
                f.parse_findings.append(Finding(
                    f.rel, line_no, tok.start[1], BAD_SUPPRESSION,
                    "unrecognized reprolint pragma (want "
                    "'# reprolint: disable=<rule> -- <reason>')"))
            continue
        rules = {r for r in m.group(1).split(",") if r}
        reason = _REASON_SEP_RE.sub("", m.group(2).strip()).strip()
        src_line = f.lines[line_no - 1] if line_no <= len(f.lines) else ""
        own = src_line.strip().startswith("#")
        unknown = sorted(r for r in rules
                         if known_rules and r not in known_rules)
        if unknown:
            f.parse_findings.append(Finding(
                f.rel, line_no, tok.start[1], BAD_SUPPRESSION,
                f"disable names unknown rule(s): {', '.join(unknown)}"))
        if not reason:
            f.parse_findings.append(Finding(
                f.rel, line_no, tok.start[1], BAD_SUPPRESSION,
                "suppression without a reason: write "
                "'# reprolint: disable=" + ",".join(sorted(rules))
                + " -- <why this is safe>'"))
        f.suppressions.append(
            Suppression(line_no, rules, reason, own))


class Project:
    """Every parsed file under the lint roots + shared lazy indexes."""

    def __init__(self, files: Sequence[SourceFile]):
        self.files: List[SourceFile] = sorted(files, key=lambda f: f.rel)
        self.by_rel: Dict[str, SourceFile] = {f.rel: f for f in self.files}
        # dotted module name -> file (suffix-registered so both
        # 'repro_torch.core.controller' and 'controller' resolve)
        self.modules: Dict[str, SourceFile] = {}
        for f in self.files:
            dotted = _dotted_module(f.rel)
            parts = dotted.split(".")
            for i in range(len(parts)):
                self.modules.setdefault(".".join(parts[i:]), f)
            self.modules[dotted] = f
        self._callgraph = None

    @property
    def callgraph(self):
        if self._callgraph is None:
            from repro_torch.analysis.callgraph import CallGraph
            self._callgraph = CallGraph.build(self)
        return self._callgraph


def _dotted_module(rel: str) -> str:
    p = rel[:-3] if rel.endswith(".py") else rel
    parts = [x for x in p.split("/") if x]
    if parts and parts[0] in ("src", "tests"):
        parts = parts[1:] or parts
    if parts and parts[-1] == "__init__":
        parts = parts[:-1] or parts
    return ".".join(parts)


def load_file(path: str, rel: Optional[str] = None,
              known_rules: Optional[Set[str]] = None) -> SourceFile:
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    rel = (rel or path).replace(os.sep, "/")
    try:
        tree = ast.parse(text, filename=rel)
        f = SourceFile(path, rel, text, tree)
    except SyntaxError as e:
        f = SourceFile(path, rel, text, None)
        f.parse_findings.append(Finding(
            rel, e.lineno or 1, (e.offset or 1) - 1, PARSE_ERROR,
            f"syntax error: {e.msg}"))
    _scan_pragmas(f, known_rules or set())
    return f


def discover(paths: Sequence[str], root: Optional[str] = None,
             known_rules: Optional[Set[str]] = None) -> Project:
    """Walk ``paths`` (files or directories) into a :class:`Project`."""
    root = os.path.abspath(root or os.getcwd())
    seen: Dict[str, str] = {}
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            seen[ap] = os.path.relpath(ap, root)
        elif os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith(".")
                                     and d != "__pycache__")
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        fp = os.path.join(dirpath, name)
                        seen[fp] = os.path.relpath(fp, root)
    files = [load_file(p, rel, known_rules) for p, rel in sorted(seen.items())]
    return Project(files)


class Rule:
    """Base class: subclasses set ``id``/``doc`` and implement ``run``."""

    id: str = ""
    doc: str = ""

    def run(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError


def run_rules(project: Project, rules: Sequence[Rule]) -> List[Finding]:
    """Run every rule, apply suppressions, append pragma findings."""
    raw: List[Finding] = []
    for rule in rules:
        for fd in rule.run(project):
            raw.append(fd)
    out: List[Finding] = []
    for fd in raw:
        f = project.by_rel.get(fd.path)
        if f is not None and fd.rule in f.suppressed_rules_for(fd.line):
            continue
        out.append(fd)
    for f in project.files:
        out.extend(f.parse_findings)
    return sorted(set(out))


# -- reporters --------------------------------------------------------------


def render_text(findings: Sequence[Finding]) -> str:
    lines = [f.render() for f in findings]
    lines.append(f"{len(findings)} finding(s)")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding],
                extra: Optional[dict] = None) -> str:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    doc = {"version": 1,
           "findings": [f.as_dict() for f in findings],
           "counts": dict(sorted(counts.items())),
           "total": len(findings)}
    if extra:
        doc.update(extra)
    return json.dumps(doc, indent=2, sort_keys=False) + "\n"


# -- small AST helpers shared by rules --------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_no_nested_defs(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk over a function body that does NOT descend into nested
    function/class definitions (those are separate lint scopes)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def const_str_elems(node: ast.AST) -> Optional[List[str]]:
    """List of string constants from a str / tuple / list literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    return None


def const_int_elems(node: ast.AST) -> Optional[List[int]]:
    """List of int constants from an int / tuple / list literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                out.append(e.value)
            else:
                return None
        return out
    return None
