"""AST-based API-documentation linter for module classes.

Counterpart of torchrec_tpu/linter/module_linter.py, with the same rules,
so that it gives JAX's issues on any source file: a public subclass of a
`Module` (torch's `nn.Module`, flax's) or of `PredictModule` must have a
docstring, and one whose `__call__` / `forward` / `update` takes more
than one argument besides self should document them (an "Args:" section
or a mention of each). It reads the source as text and imports nothing
of it.
"""

from __future__ import annotations

import ast
from typing import List, Optional

MAX_NUM_ARGS_IN_MODULE_CTOR = 7


def _docstring(node: ast.AST) -> Optional[str]:
    body = getattr(node, "body", None)
    if (
        body
        and isinstance(body[0], ast.Expr)
        and isinstance(body[0].value, ast.Constant)
        and isinstance(body[0].value.value, str)
    ):
        return body[0].value.value
    return None


def _is_module_class(node: ast.ClassDef) -> bool:
    for base in node.bases:
        name = ""
        if isinstance(base, ast.Attribute):
            name = base.attr
        elif isinstance(base, ast.Name):
            name = base.id
        if name in ("Module", "PredictModule"):
            return True
    return False


def check_class_definition(node: ast.ClassDef) -> List[str]:
    """Lint one class; returns a list of human-readable issues."""
    issues: List[str] = []
    if node.name.startswith("_"):
        return issues
    doc = _docstring(node)
    if not doc:
        issues.append(f"{node.name}:{node.lineno}: missing class docstring")
        return issues
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name not in ("__call__", "forward", "update"):
            continue
        args = [
            a.arg
            for a in item.args.args
            if a.arg not in ("self", "cls")
        ]
        if len(args) <= 1:
            continue
        fdoc = _docstring(item) or doc
        missing = [a for a in args if a not in fdoc]
        if missing and "Args:" not in fdoc and "Call Args:" not in fdoc:
            issues.append(
                f"{node.name}.{item.name}:{item.lineno}: arguments "
                f"{missing} undocumented (no Args section either)"
            )
    n_fields = sum(
        1
        for item in node.body
        if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name)
        and not item.target.id.startswith("_")
    )
    if n_fields > MAX_NUM_ARGS_IN_MODULE_CTOR and "Args:" not in doc:
        issues.append(
            f"{node.name}:{node.lineno}: {n_fields} config fields but no "
            "Args: section in the class docstring"
        )
    return issues


def linter_one_file(path: str) -> List[str]:
    """Lint every module class in one python file.

    Args:
        path: python source file to check.

    Returns:
        list of issue strings (empty = clean).
    """
    with open(path, "r") as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    issues: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and _is_module_class(node):
            issues.extend(
                f"{path}:{msg}" for msg in check_class_definition(node)
            )
    return issues
