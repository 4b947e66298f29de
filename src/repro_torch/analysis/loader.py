"""AST module loader for the repro-check analysis suite.

Parses a Python package (no imports are executed — analysis must work on
modules whose import-time side effects we do not want) into ``Module``
objects carrying the AST, the raw source lines, and the in-code
``repro-check`` annotations:

    # repro-check: allow(blocking) -- non-blocking socket, audited 2026-08

An annotation applies to

  * the code on its own line (trailing comment),
  * the next non-blank code line (standalone comment line), and
  * the whole function body when it sits on (or directly above) a
    ``def`` line.

Annotations are how audited exceptions are recorded *next to the code
they excuse* — the committed baseline is for findings that are still
open, never for permanent waivers.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterator

_ALLOW_RE = re.compile(
    r"#\s*repro-check:\s*allow\(\s*([\w\-, ]+?)\s*\)")


@dataclasses.dataclass
class Module:
    """One parsed source file."""

    name: str                 # dotted name relative to the scan root
    path: str                 # repo-relative path (stable in findings)
    tree: ast.Module
    lines: list[str]
    # line number (1-based) -> set of allow tags effective on that line
    allows: dict[int, set[str]]
    # function-def line -> tags that cover the whole function body
    func_allows: dict[int, set[str]]

    def is_allowed(self, line: int, tag: str) -> bool:
        return tag in self.allows.get(line, ())

    def function_allowed(self, func: ast.AST, tag: str) -> bool:
        return tag in self.func_allows.get(getattr(func, "lineno", -1), ())


def _parse_allows(lines: list[str]) -> tuple[dict[int, set[str]],
                                             dict[int, set[str]]]:
    """Map annotation comments to the lines they cover."""
    allows: dict[int, set[str]] = {}
    func_allows: dict[int, set[str]] = {}

    def add(lineno: int, tags: set[str]) -> None:
        allows.setdefault(lineno, set()).update(tags)

    for i, text in enumerate(lines, start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        tags = {t.strip() for t in m.group(1).split(",") if t.strip()}
        code = text[: m.start()].strip()
        target = i
        if not code:
            # standalone comment: push down to the next code line
            for j in range(i, len(lines)):
                nxt = lines[j].strip()
                if nxt and not nxt.startswith("#"):
                    target = j + 1
                    break
        add(target, tags)
        target_code = (lines[target - 1].strip()
                       if target - 1 < len(lines) else "")
        if target_code.startswith(("def ", "async def ")):
            func_allows.setdefault(target, set()).update(tags)
    return allows, func_allows


@dataclasses.dataclass
class FunctionInfo:
    """A function or method with enough context to resolve calls."""

    qual: str                     # "module.Class.method" or "module.func"
    name: str
    module: "Module"
    node: ast.FunctionDef
    cls: str | None               # owning class qual ("module.Class")


@dataclasses.dataclass
class ClassInfo:
    qual: str                     # "module.Class"
    name: str
    module: "Module"
    node: ast.ClassDef
    bases: list[str]              # raw base-name text (resolved lazily)
    methods: dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)


class Project:
    """All loaded modules plus symbol indexes used by the checkers."""

    def __init__(self, root: Path, repo_root: Path | None = None):
        self.root = Path(root)
        self.repo_root = Path(repo_root) if repo_root else self.root
        self.modules: dict[str, Module] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        # method name -> every FunctionInfo with that name (may-call sets)
        self.methods_by_name: dict[str, list[FunctionInfo]] = {}
        # module name -> {local alias -> dotted import target}
        self.imports: dict[str, dict[str, str]] = {}

    # ------------------------------------------------------------------ #
    # loading
    # ------------------------------------------------------------------ #
    def load(self) -> "Project":
        for path in sorted(self.root.rglob("*.py")):
            rel = path.relative_to(self.root)
            name = ".".join(rel.with_suffix("").parts)
            if name.endswith(".__init__"):
                name = name[: -len(".__init__")]
            elif name == "__init__":
                name = ""
            self._load_file(path, name or rel.stem)
        self._index()
        return self

    def load_file(self, path: Path, name: str | None = None) -> "Project":
        path = Path(path)
        self._load_file(path, name or path.stem)
        self._index()
        return self

    def _load_file(self, path: Path, name: str) -> None:
        source = path.read_text()
        try:
            rel_path = str(path.relative_to(self.repo_root))
        except ValueError:
            rel_path = str(path)
        allows, func_allows = _parse_allows(source.splitlines())
        self.modules[name] = Module(
            name=name, path=rel_path, tree=ast.parse(source),
            lines=source.splitlines(), allows=allows,
            func_allows=func_allows)

    def _index(self) -> None:
        self.classes.clear()
        self.functions.clear()
        self.methods_by_name.clear()
        self.imports.clear()
        for mod in self.modules.values():
            imports: dict[str, str] = {}
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        imports[alias.asname or alias.name.split(".")[0]] = \
                            alias.name
                elif isinstance(node, ast.ImportFrom):
                    base = node.module or ""
                    for alias in node.names:
                        imports[alias.asname or alias.name] = \
                            f"{base}.{alias.name}" if base else alias.name
            self.imports[mod.name] = imports
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._add_function(mod, node, cls=None)
                elif isinstance(node, ast.ClassDef):
                    cls_qual = f"{mod.name}.{node.name}"
                    info = ClassInfo(
                        qual=cls_qual, name=node.name, module=mod,
                        node=node,
                        bases=[ast.unparse(b) for b in node.bases])
                    self.classes[cls_qual] = info
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            fi = self._add_function(mod, item, cls=cls_qual)
                            info.methods[item.name] = fi

    def _add_function(self, mod: Module, node, cls: str | None
                      ) -> FunctionInfo:
        qual = (f"{cls}.{node.name}" if cls
                else f"{mod.name}.{node.name}")
        fi = FunctionInfo(qual=qual, name=node.name, module=mod,
                          node=node, cls=cls)
        self.functions[qual] = fi
        self.methods_by_name.setdefault(node.name, []).append(fi)
        return fi

    # ------------------------------------------------------------------ #
    # symbol resolution helpers
    # ------------------------------------------------------------------ #
    def class_by_name(self, name: str) -> list[ClassInfo]:
        return [c for c in self.classes.values() if c.name == name]

    def mro(self, cls_qual: str) -> Iterator[ClassInfo]:
        """The class and its loaded ancestors (best-effort linearization)."""
        seen: set[str] = set()
        stack = [cls_qual]
        while stack:
            qual = stack.pop(0)
            if qual in seen or qual not in self.classes:
                continue
            seen.add(qual)
            info = self.classes[qual]
            yield info
            for base in info.bases:
                base_name = base.split(".")[-1]
                for cand in self.class_by_name(base_name):
                    stack.append(cand.qual)

    def subclasses(self, cls_qual: str) -> Iterator[ClassInfo]:
        """Loaded classes that (transitively) derive from ``cls_qual``."""
        target = self.classes.get(cls_qual)
        if target is None:
            return
        for info in self.classes.values():
            if info.qual == cls_qual:
                continue
            if any(m.qual == cls_qual for m in self.mro(info.qual)):
                yield info


def load_core(repo_root: str | Path, rel: str = "src/repro_torch/core"
              ) -> Project:
    """Load the core package rooted at ``repo_root``."""
    repo_root = Path(repo_root)
    return Project(repo_root / rel, repo_root=repo_root).load()
