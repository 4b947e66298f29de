"""Wire-schema drift checker.

The client (``client.py``/``transport.py``) and the server surface
(``api/schemas.py`` + ``api/v2.py`` routes + server-raised error codes)
are maintained by hand on both sides of the wire.  This checker parses
both and cross-checks them statically, so a server-side change the
client cannot handle fails `repro-check` instead of a production call:

``client-route-mismatch``
    a client ``_call``/``_request`` path that matches no registered
    route (method + template);

``client-field-unknown``
    a literal body key the route's request schema does not declare
    (the server ignores unknown keys — silently dropping client intent);

``client-missing-required``
    a required schema field (no default) absent from the client's
    literal body;

``error-code-drift``
    an error code the client branches on (retry policy, equality
    checks) that no server-side code path raises.

``probe-route-mismatch``
    a literal ``/api/...`` path used by an *internal* probe (the fabric
    router's fast-path classifiers, the health scatter-gather, the
    service launcher) that matches no registered route — the fabric
    would 404 its own monitoring;

``health-field-drift``
    a payload key a scatter-gather consumer reads (``x.get("k")`` /
    ``x["k"]``) that no producer function on that surface ever emits —
    renaming a health field silently turns a consumer read into
    ``None``.

All parsing is AST-level; nothing is imported.
"""
from __future__ import annotations

import ast
import re

from ..findings import Finding
from ..loader import Module, Project

DEFAULT_CONFIG = {
    "client_module": "client",
    "schemas_module": "api.schemas",
    "routes_modules": ("api.v2", "api.v1"),
    # modules scanned for server-raised codes: ApiError(status, code, ...),
    # error_payload(code, ...), HopaasError(code=...)
    "code_modules": None,        # None = every loaded module
    # codes produced outside the scanned sources (none today)
    "extra_codes": (),
    # modules whose literal "/api/..." strings are internal probes that
    # must match a registered route (trailing-slash prefixes exempt)
    "probe_modules": ("fabric", "aio", "service"),
    # scatter-gather surfaces: consumer key reads ⊆ producer key emits
    "health_surfaces": (
        {"name": "replication-status",
         "producers": ("replication.ReplicationHub.status",
                       "replication.ReplicationClient.status",
                       "fabric.FabricWorkerServer._replication_status",
                       "fabric.FabricWorkerServer._op_promote"),
         "consumers": ("fabric.ShardFabric._failover",)},
        {"name": "health-endpoint",
         "producers": ("server.HopaasServer.op_health",
                       "fabric.FabricWorkerServer.health_extra",
                       "fabric.FabricWorkerServer._replication_status"),
         "consumers": ("fabric.ShardFabric.health",)},
    ),
}


# ----------------------------------------------------------------------- #
# schema model
# ----------------------------------------------------------------------- #
def _schema_fields(mod: Module) -> dict[str, dict[str, dict]]:
    """class name -> {field name -> {"required": bool, "has_default": bool}}.

    Understands the repo idiom: ``FIELDS = (Field(...), ...)`` tuples,
    optionally concatenated with ``Other.FIELDS``.
    """
    classes: dict[str, dict[str, dict]] = {}
    pending: dict[str, ast.expr] = {}
    for node in mod.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        fields_expr = None
        for item in node.body:
            if (isinstance(item, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "FIELDS"
                            for t in item.targets)):
                fields_expr = item.value
            elif (isinstance(item, ast.AnnAssign)
                  and isinstance(item.target, ast.Name)
                  and item.target.id == "FIELDS" and item.value):
                fields_expr = item.value
        base_names = [ast.unparse(b).split(".")[-1] for b in node.bases]
        if fields_expr is None:
            # inherits FIELDS unchanged
            for base in base_names:
                if base in classes:
                    classes[node.name] = dict(classes[base])
                    break
            else:
                classes[node.name] = {}
            continue
        pending[node.name] = fields_expr
        classes[node.name] = _eval_fields(fields_expr, classes)
    return classes


def _eval_fields(expr: ast.expr, classes: dict) -> dict[str, dict]:
    out: dict[str, dict] = {}
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        out.update(_eval_fields(expr.left, classes))
        out.update(_eval_fields(expr.right, classes))
        return out
    if isinstance(expr, ast.Attribute) and expr.attr == "FIELDS":
        owner = ast.unparse(expr.value).split(".")[-1]
        return dict(classes.get(owner, {}))
    if isinstance(expr, (ast.Tuple, ast.List)):
        for el in expr.elts:
            out.update(_eval_fields(el, classes))
        return out
    if isinstance(expr, ast.Call):
        fn = expr.func
        name = (fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else "")
        if name == "Field" and expr.args and isinstance(
                expr.args[0], ast.Constant):
            kw = {k.arg: k.value for k in expr.keywords}
            required = (isinstance(kw.get("required"), ast.Constant)
                        and kw["required"].value is True)
            has_default = "default" in kw
            out[expr.args[0].value] = {"required": required,
                                       "has_default": has_default}
    return out


# ----------------------------------------------------------------------- #
# route model
# ----------------------------------------------------------------------- #
def _routes(mod: Module) -> list[dict]:
    """Every ``Route(...)`` literal: method, template, schema name."""
    out = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "Route"
                and len(node.args) >= 2
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[1], ast.Constant)):
            continue
        schema = None
        for kw in node.keywords:
            if kw.arg == "request_schema":
                schema = ast.unparse(kw.value).split(".")[-1]
        out.append({"method": node.args[0].value.upper(),
                    "template": node.args[1].value,
                    "schema": schema,
                    "line": node.lineno,
                    "path": mod.path})
    return out


def _seg_match(client_seg: str, tmpl_seg: str) -> bool:
    """One path segment: client ``{x}`` holes (f-string interpolations)
    and template ``{param}`` holes both match anything; the literal
    fragments around the holes must line up.  ``trials{x}`` matches the
    literal ``trials`` — the hole is a prebuilt query string."""
    c_re = ".*".join(re.escape(p) for p in client_seg.split("{x}"))
    t_concrete = re.sub(r"\{\w+\}", "\x00", tmpl_seg)
    if re.fullmatch(c_re, t_concrete):
        return True
    t_re = ".*".join(re.escape(p)
                     for p in re.split(r"\{\w+\}", tmpl_seg))
    c_concrete = client_seg.replace("{x}", "\x00")
    return re.fullmatch(t_re, c_concrete) is not None


def _path_match(client_path: str, template: str) -> bool:
    """Client path (with ``{x}`` interpolation holes, possibly a glued
    ``?query``) vs a route template, segment by segment."""
    c = client_path.partition("?")[0]
    c_segs = c.strip("/").split("/")
    t_segs = template.strip("/").split("/")
    if len(c_segs) != len(t_segs):
        return False
    return all(_seg_match(cs, ts) for cs, ts in zip(c_segs, t_segs))


# ----------------------------------------------------------------------- #
# client model
# ----------------------------------------------------------------------- #
def _client_calls(mod: Module) -> list[dict]:
    """Every ``self._call(method, path, body?)`` in the client."""
    out = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("_call", "_request")
                and len(node.args) >= 2):
            continue
        method_node, path_node = node.args[0], node.args[1]
        if not isinstance(method_node, ast.Constant):
            continue
        path = _path_text(path_node)
        if path is None:
            continue
        body_keys: list[str] | None = None
        if len(node.args) >= 3 and isinstance(node.args[2], ast.Dict):
            body_keys = [k.value for k in node.args[2].keys
                         if isinstance(k, ast.Constant)]
        elif len(node.args) >= 3 and isinstance(node.args[2],
                                                ast.Constant) \
                and node.args[2].value is None:
            body_keys = []
        out.append({"method": method_node.value.upper(), "path": path,
                    "body_keys": body_keys, "line": node.lineno})
    return out


def _path_text(node: ast.expr) -> str | None:
    """Constant or f-string path -> template-ish text with {x} holes."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("{x}")
        return "".join(parts)
    return None


def _client_codes(mod: Module) -> list[tuple[str, int]]:
    """Error-code strings the client logic branches on."""
    out: list[tuple[str, int]] = []
    for node in ast.walk(mod.tree):
        # e.code ==/!=/in "..." comparisons
        if isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            involves_code = any(
                isinstance(s, ast.Attribute) and s.attr == "code"
                for s in sides)
            if involves_code:
                for s in sides:
                    if isinstance(s, ast.Constant) and isinstance(
                            s.value, str):
                        out.append((s.value, node.lineno))
                    elif isinstance(s, (ast.Tuple, ast.List)):
                        out.extend((el.value, node.lineno)
                                   for el in s.elts
                                   if isinstance(el, ast.Constant)
                                   and isinstance(el.value, str))
        # RetryPolicy retry_codes defaults / assignments
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names = {t.id for t in targets if isinstance(t, ast.Name)}
            names |= {t.attr for t in targets
                      if isinstance(t, ast.Attribute)}
            if "retry_codes" in names and node.value is not None:
                for el in ast.walk(node.value):
                    if isinstance(el, ast.Constant) and isinstance(
                            el.value, str):
                        out.append((el.value, node.lineno))
    return out


def _probe_paths(mod: Module) -> list[tuple[str, int]]:
    """Literal ``/api/...`` strings used as internal probe paths.
    Trailing-slash values are prefix constants (``startswith`` guards,
    URL builders), not full paths — those are exempt.  Fragments inside
    an f-string are judged as the whole joined text, not per part."""
    joined_parts: set[int] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.JoinedStr):
            joined_parts.update(id(v) for v in node.values)
    out: list[tuple[str, int]] = []
    for node in ast.walk(mod.tree):
        if id(node) in joined_parts:
            continue
        if not isinstance(node, (ast.Constant, ast.JoinedStr)):
            continue
        text = _path_text(node)
        if (text and text.startswith("/api/")
                and not text.partition("?")[0].endswith("/")):
            out.append((text, node.lineno))
    return out


def _produced_keys(project: Project, quals: tuple) -> set[str]:
    """String keys a producer function can emit: dict-literal keys plus
    ``out["key"] = ...`` subscript stores.  ``update(other.status())``
    composition is covered by listing every producer on the surface."""
    keys: set[str] = set()
    for qual in quals:
        fn = project.functions.get(qual)
        if fn is None:
            continue
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Dict):
                keys.update(k.value for k in node.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str))
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, (ast.Store, ast.Del))
                  and isinstance(node.slice, ast.Constant)
                  and isinstance(node.slice.value, str)):
                keys.add(node.slice.value)
    return keys


def _consumed_keys(project: Project, quals: tuple
                   ) -> list[tuple[str, int, str, Module]]:
    """(key, line, consumer qual, module) for every constant-string
    ``x.get("k")`` call or ``x["k"]`` load in the consumer functions."""
    out: list[tuple[str, int, str, Module]] = []
    for qual in quals:
        fn = project.functions.get(qual)
        if fn is None:
            continue
        for node in ast.walk(fn.node):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append((node.args[0].value, node.lineno, qual,
                            fn.module))
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, ast.Load)
                  and isinstance(node.slice, ast.Constant)
                  and isinstance(node.slice.value, str)):
                out.append((node.slice.value, node.lineno, qual,
                            fn.module))
    return out


def _server_codes(project: Project, modules: tuple | None) -> set[str]:
    codes: set[str] = set()
    for mod in project.modules.values():
        if modules is not None and mod.name not in modules:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else "")
            if name == "ApiError" and len(node.args) >= 2 and isinstance(
                    node.args[1], ast.Constant):
                codes.add(node.args[1].value)
            elif name == "error_payload" and node.args and isinstance(
                    node.args[0], ast.Constant):
                codes.add(node.args[0].value)
            elif name in ("HopaasError",):
                for kw in node.keywords:
                    if kw.arg == "code" and isinstance(
                            kw.value, ast.Constant) and isinstance(
                            kw.value.value, str):
                        codes.add(kw.value.value)
    return codes


# ----------------------------------------------------------------------- #
def run(project: Project, config: dict | None = None) -> list[Finding]:
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    findings: list[Finding] = []

    client = project.modules.get(cfg["client_module"])
    schemas_mod = project.modules.get(cfg["schemas_module"])
    if client is None or schemas_mod is None:
        findings.append(Finding(
            checker="wire-schema", rule="missing-module", path="", line=0,
            symbol="",
            message=f"client/schemas modules not found "
                    f"({cfg['client_module']!r}, "
                    f"{cfg['schemas_module']!r})",
            detail="missing-module"))
        return findings

    schemas = _schema_fields(schemas_mod)
    routes: list[dict] = []
    for name in cfg["routes_modules"]:
        mod = project.modules.get(name)
        if mod is not None:
            routes.extend(_routes(mod))
    for call in _client_calls(client):
        matches = [r for r in routes
                   if r["method"] == call["method"]
                   and _path_match(call["path"], r["template"])]
        if not matches:
            if client.is_allowed(call["line"], "wire"):
                continue
            findings.append(Finding(
                checker="wire-schema", rule="client-route-mismatch",
                path=client.path, line=call["line"], symbol="",
                message=f"client calls {call['method']} "
                        f"{call['path']!r} but no route matches",
                detail=f"{call['method']}|{call['path']}"))
            continue
        route = matches[0]
        schema_name = route["schema"]
        if schema_name is None or call["body_keys"] is None:
            continue
        fields = schemas.get(schema_name)
        if fields is None:
            continue
        for key in call["body_keys"]:
            if key not in fields:
                if client.is_allowed(call["line"], "wire"):
                    continue
                findings.append(Finding(
                    checker="wire-schema", rule="client-field-unknown",
                    path=client.path, line=call["line"], symbol="",
                    message=f"client sends field {key!r} to "
                            f"{route['method']} {route['template']} but "
                            f"schema {schema_name} does not declare it "
                            f"(server silently drops it)",
                    detail=f"{route['template']}|{key}"))
        for name, spec in fields.items():
            if spec["required"] and not spec["has_default"] \
                    and name not in call["body_keys"]:
                if client.is_allowed(call["line"], "wire"):
                    continue
                findings.append(Finding(
                    checker="wire-schema", rule="client-missing-required",
                    path=client.path, line=call["line"], symbol="",
                    message=f"client body for {route['method']} "
                            f"{route['template']} omits required field "
                            f"{name!r} of schema {schema_name}",
                    detail=f"{route['template']}|missing|{name}"))

    for mod_name in cfg["probe_modules"]:
        mod = project.modules.get(mod_name)
        if mod is None:
            continue
        for path, line in _probe_paths(mod):
            if any(_path_match(path, r["template"]) for r in routes):
                continue
            if mod.is_allowed(line, "wire"):
                continue
            findings.append(Finding(
                checker="wire-schema", rule="probe-route-mismatch",
                path=mod.path, line=line, symbol="",
                message=f"internal probe uses path {path!r} but no "
                        f"registered route matches it",
                detail=f"probe|{mod_name}|{path}"))

    for surface in cfg["health_surfaces"]:
        produced = _produced_keys(project, surface["producers"])
        if not produced:
            # every producer renamed/moved: the surface silently reads
            # as fully drifted — report the coverage loss, not N keys
            findings.append(Finding(
                checker="wire-schema", rule="health-field-drift",
                path="", line=0, symbol=surface["name"],
                message=f"health surface {surface['name']!r}: no "
                        f"producer function found "
                        f"({', '.join(surface['producers'])})",
                detail=f"surface-empty|{surface['name']}"))
            continue
        for key, line, qual, mod in _consumed_keys(
                project, surface["consumers"]):
            if key in produced:
                continue
            if mod.is_allowed(line, "wire"):
                continue
            findings.append(Finding(
                checker="wire-schema", rule="health-field-drift",
                path=mod.path, line=line, symbol=qual,
                message=f"{qual} reads payload key {key!r} but no "
                        f"producer on the {surface['name']!r} surface "
                        f"emits it",
                detail=f"{surface['name']}|{qual}|{key}"))

    server_codes = _server_codes(project, cfg["code_modules"])
    server_codes.update(cfg["extra_codes"])
    for code, line in _client_codes(client):
        if code not in server_codes:
            if client.is_allowed(line, "wire"):
                continue
            findings.append(Finding(
                checker="wire-schema", rule="error-code-drift",
                path=client.path, line=line, symbol="",
                message=f"client handles error code {code!r} but no "
                        f"server path raises it",
                detail=f"code|{code}"))

    seen: set[str] = set()
    out = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
