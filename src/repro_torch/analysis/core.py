"""The port's lint framework: findings, suppressions, the module model and
the rule registry.

The port's own copy of ``repro.analysis.core`` (the port imports nothing
of the JAX package), stdlib only like it: rules reason about source (the
AST and the import graph), never about live objects, so the linter runs
without torch.  Suppressions use the JAX linter's directives (``#
reprolint: disable=RL010``, ``# reprolint: disable-file=RL003``), so one
comment serves both.  Paths may be globs (``tests/test_torch_*.py``),
expanded from the root.
"""
from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "Suppressions", "ModuleInfo", "LintReport",
    "module_rule", "project_rule", "iter_rules", "rule_table",
    "lint_paths", "discover_files", "qualname", "collect_aliases",
    "DEFAULT_PATHS", "EXCLUDED_DIRS",
]

# Directories never walked when a *directory* is linted.  ``lint_fixtures``
# is the linter's own seeded-violation corpus (tests pass those files
# explicitly); explicit file arguments always bypass the exclusions.
EXCLUDED_DIRS = frozenset({
    "__pycache__", ".git", ".pytest_cache", "lint_fixtures", ".venv", "node_modules",
})

# What `python -m repro_torch.analysis` lints when given no paths: the
# port's tree (globs are expanded from the root).
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py",
                 "tests/torch_*_cases.py", "scripts/torch_*.py",
                 "chip_smoke.py")


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str                 # e.g. "RL001"
    message: str
    path: str                 # repo-relative, posix separators
    line: int                 # 1-based
    col: int = 0              # 0-based (ast convention)
    rule: str = ""            # short rule name, e.g. "compat-drift"

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------
# Inline suppressions
# --------------------------------------------------------------------------

_INLINE_RE = re.compile(r"#\s*reprolint:\s*disable=([A-Za-z0-9_,\s]+?|all)\s*(?:#|$)")
_FILE_RE = re.compile(r"#\s*reprolint:\s*disable-file=([A-Za-z0-9_,\s]+?|all)\s*(?:#|$)")


def _parse_codes(raw: str) -> frozenset:
    return frozenset(c.strip().upper() for c in raw.split(",") if c.strip())


class Suppressions:
    """Per-file suppression directives, parsed from raw source lines."""

    def __init__(self, source: str):
        self.by_line: Dict[int, frozenset] = {}
        self.file_level: frozenset = frozenset()
        for i, text in enumerate(source.splitlines(), start=1):
            m = _FILE_RE.search(text)
            if m:
                self.file_level = self.file_level | _parse_codes(m.group(1))
                continue
            m = _INLINE_RE.search(text)
            if m:
                codes = _parse_codes(m.group(1))
                self.by_line[i] = self.by_line.get(i, frozenset()) | codes
                # a standalone directive comment suppresses the next line
                # too (black-wrapped statements can't always host a trailer)
                if text.lstrip().startswith("#"):
                    self.by_line[i + 1] = \
                        self.by_line.get(i + 1, frozenset()) | codes

    def covers(self, code: str, line: int) -> bool:
        code = code.upper()
        for scope in (self.file_level, self.by_line.get(line, frozenset())):
            if "ALL" in scope or code in scope:
                return True
        return False


# --------------------------------------------------------------------------
# Import-graph resolution
# --------------------------------------------------------------------------

def collect_aliases(tree: ast.AST,
                    package: Optional[str] = None) -> Dict[str, str]:
    """Local name -> fully-qualified dotted origin, for every import.

    ``import a.b.c``            binds ``a`` -> ``a``
    ``import a.b.c as x``       binds ``x`` -> ``a.b.c``
    ``from a.b import c``       binds ``c`` -> ``a.b.c``
    ``from a.b import c as x``  binds ``x`` -> ``a.b.c``
    ``from . import engine``    resolves relative to ``package`` when known
                                (the module's containing package).
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    root = a.name.split(".", 1)[0]
                    aliases.setdefault(root, root)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level and package:
                pkg_parts = package.split(".")
                # level 1 = the containing package; each extra level climbs
                anchor = pkg_parts[: max(len(pkg_parts) - (node.level - 1), 0)]
                base = ".".join(anchor + ([node.module] if node.module
                                          else []))
            for a in node.names:
                if a.name == "*":
                    continue
                full = f"{base}.{a.name}" if base else a.name
                aliases[a.asname or a.name] = full
    return aliases


def qualname(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted path of a Name/Attribute chain with aliases substituted.

    ``sm.shard_map`` with ``sm -> jax.experimental.shard_map`` resolves to
    ``jax.experimental.shard_map.shard_map``.  Returns None for chains
    rooted in anything but a plain name (calls, subscripts, literals).
    """
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id, node.id)
    parts.append(root)
    return ".".join(reversed(parts))


@dataclasses.dataclass
class ModuleInfo:
    path: str                      # repo-relative posix path
    abspath: str
    module: Optional[str]          # dotted name when under a src root
    source: str
    tree: ast.AST
    aliases: Dict[str, str]
    suppressions: Suppressions

    @property
    def is_test_file(self) -> bool:
        return os.path.basename(self.path).startswith("test_")


def _module_name(relpath: str) -> Tuple[Optional[str], Optional[str]]:
    """(dotted module name, containing package) for files under ``src/``."""
    p = relpath.replace(os.sep, "/")
    if not p.startswith("src/") or not p.endswith(".py"):
        return None, None
    mod = p[len("src/"):-len(".py")]
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
        pkg = mod                       # a package is its own anchor
    else:
        pkg = mod.rsplit("/", 1)[0] if "/" in mod else None
    return (mod.replace("/", "."),
            pkg.replace("/", ".") if pkg else None)


def load_module(abspath: str, root: str) -> Optional[ModuleInfo]:
    rel = os.path.relpath(abspath, root).replace(os.sep, "/")
    try:
        with open(abspath, "r", encoding="utf-8") as fh:
            source = fh.read()
        tree = ast.parse(source, filename=abspath)
    except (OSError, SyntaxError, ValueError):
        return None
    module, package = _module_name(rel)
    return ModuleInfo(path=rel, abspath=abspath, module=module, source=source,
                      tree=tree, aliases=collect_aliases(tree, package),
                      suppressions=Suppressions(source))


# --------------------------------------------------------------------------
# Rule registry
# --------------------------------------------------------------------------

_MODULE_RULES: List[Callable] = []
_PROJECT_RULES: List[Callable] = []


def _register(registry: List[Callable], code: str, name: str, summary: str):
    def deco(fn):
        fn.code = code
        fn.rule_name = name
        fn.summary = summary
        registry.append(fn)
        return fn
    return deco


def module_rule(code: str, name: str, summary: str):
    """Register a per-file rule: ``fn(mod: ModuleInfo) -> Iterable[Finding]``."""
    return _register(_MODULE_RULES, code, name, summary)


def project_rule(code: str, name: str, summary: str):
    """Register a once-per-run rule: ``fn(root, files) -> Iterable[Finding]``."""
    return _register(_PROJECT_RULES, code, name, summary)


def iter_rules() -> List[Callable]:
    # importing the rules module registers them; local import breaks the
    # cycle (rules.py imports this module's decorators)
    from repro_torch.analysis import rules as _rules  # noqa: F401
    return sorted(_MODULE_RULES + _PROJECT_RULES, key=lambda r: r.code)


def rule_table() -> List[Tuple[str, str, str]]:
    return [(r.code, r.rule_name, r.summary) for r in iter_rules()]


# --------------------------------------------------------------------------
# Runner
# --------------------------------------------------------------------------

def discover_files(paths: Sequence[str], root: str) -> List[str]:
    """Python files to lint.  Directories are walked (minus EXCLUDED_DIRS);
    explicitly named files are taken as-is, excluded or not."""
    out: List[str] = []
    seen = set()
    expanded: List[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        expanded.extend(sorted(glob.glob(ap)) if glob.has_magic(ap)
                        else [ap])
    for ap in expanded:
        if os.path.isfile(ap):
            if ap not in seen:
                seen.add(ap)
                out.append(ap)
        elif os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in EXCLUDED_DIRS)
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        f = os.path.join(dirpath, fn)
                        if f not in seen:
                            seen.add(f)
                            out.append(f)
    return out


@dataclasses.dataclass
class LintReport:
    findings: List[Finding]
    suppressed: List[Finding]
    files_scanned: int
    errors: List[str]

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "files_scanned": self.files_scanned,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "errors": list(self.errors),
            "rules": [{"code": c, "name": n, "summary": s}
                      for c, n, s in rule_table()],
        }


def _selected(code: str, select, ignore) -> bool:
    if select and code.upper() not in {c.upper() for c in select}:
        return False
    if ignore and code.upper() in {c.upper() for c in ignore}:
        return False
    return True


def lint_paths(paths: Sequence[str], root: Optional[str] = None,
               select: Optional[Sequence[str]] = None,
               ignore: Optional[Sequence[str]] = None) -> LintReport:
    """Run every registered rule over ``paths``; returns the full report.

    ``root`` anchors repo-relative paths, module-name resolution and the
    project-level rules (default: cwd).  Findings covered by an inline or
    file-level suppression land in ``report.suppressed``.
    """
    # rules import registers them; local import avoids a cycle at package
    # import time (rules.py imports this module's decorators)
    from repro_torch.analysis import rules as _rules  # noqa: F401

    root = os.path.abspath(root or os.getcwd())
    files = discover_files(paths, root)
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    errors: List[str] = []
    modules: List[ModuleInfo] = []
    for f in files:
        mod = load_module(f, root)
        if mod is None:
            errors.append(f"could not parse {os.path.relpath(f, root)}")
            continue
        modules.append(mod)

    for mod in modules:
        for rule in _MODULE_RULES:
            if not _selected(rule.code, select, ignore):
                continue
            try:
                hits = list(rule(mod))
            except Exception as exc:  # a crashing rule must fail loud
                errors.append(f"rule {rule.code} crashed on {mod.path}: "
                              f"{type(exc).__name__}: {exc}")
                continue
            for h in hits:
                (suppressed if mod.suppressions.covers(h.code, h.line)
                 else findings).append(h)

    supp_by_path = {m.path: m.suppressions for m in modules}
    for rule in _PROJECT_RULES:
        if not _selected(rule.code, select, ignore):
            continue
        try:
            hits = list(rule(root, modules))
        except Exception as exc:
            errors.append(f"rule {rule.code} crashed: "
                          f"{type(exc).__name__}: {exc}")
            continue
        for h in hits:
            sup = supp_by_path.get(h.path)
            (suppressed if sup is not None and sup.covers(h.code, h.line)
             else findings).append(h)

    key = lambda f: (f.path, f.line, f.col, f.code)
    return LintReport(findings=sorted(set(findings), key=key),
                      suppressed=sorted(set(suppressed), key=key),
                      files_scanned=len(modules), errors=errors)
