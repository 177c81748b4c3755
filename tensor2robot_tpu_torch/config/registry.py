"""Configuration system: a gin-style dependency-injection registry.

Port of tensor2robot_tpu/config/registry.py, the port's own copy (the
port imports nothing of the JAX package). It registers callables under
the same names as the JAX package, so a gin file binds either package:

  * `@configurable` / `external_configurable` register callables by name.
  * Bindings `name.param = value`, scoped `scope/name.param = value`.
  * Macros `MACRO = value` referenced as `%MACRO`.
  * References `@name` (the configurable itself) and `@name()` (called at
    injection time), incl. scoped `@scope/name()`.
  * References and macros inside lists, tuples and dicts
    (`train_eval_model.hook_builders = [@StepTimingHookBuilder(), ...]`).
  * `include 'file.gin'` composition.
  * `import module` statements. `import tensor2robot_tpu.<m>` imports the
    port's `tensor2robot_tpu_torch.<m>`, so the JAX package's shipped
    configs (which start `import tensor2robot_tpu.config.defaults`) run
    unchanged on the port without loading JAX; any other import naming
    the JAX package or JAX raises ConfigError.
  * `parse_config_files_and_bindings`, `bind_parameter`, `clear_config`.
  * `operative_config_str()` — the params every configurable actually ran
    with.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import inspect
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union


class ConfigError(Exception):
    pass


class _Registry:
    def __init__(self):
        self.configurables: Dict[str, Callable] = {}
        self.bindings: Dict[Tuple[str, str], Any] = {}  # (scoped_name, param)
        self.macros: Dict[str, Any] = {}
        self.operative: Dict[str, Dict[str, Any]] = {}
        self.imports: List[str] = []
        self.lock = threading.RLock()
        self.scope_stack: List[str] = []


_REGISTRY = _Registry()


# -- registration -------------------------------------------------------------


def configurable(fn_or_name: Union[Callable, str, None] = None, *, name: Optional[str] = None):
    """Registers a function/class; its kwargs become injectable."""

    def register(fn: Callable, reg_name: Optional[str]) -> Callable:
        reg_name = reg_name or fn.__name__
        wrapped = _make_wrapper(fn, reg_name)
        with _REGISTRY.lock:
            _REGISTRY.configurables[reg_name] = wrapped
        return wrapped

    if callable(fn_or_name):
        return register(fn_or_name, name)
    outer_name = fn_or_name if isinstance(fn_or_name, str) else name

    def decorator(fn: Callable) -> Callable:
        return register(fn, outer_name)

    return decorator


def external_configurable(fn: Callable, name: Optional[str] = None) -> Callable:
    """Registers a third-party callable without modifying its module."""
    reg_name = name or fn.__name__
    wrapped = _make_wrapper(fn, reg_name)
    with _REGISTRY.lock:
        _REGISTRY.configurables[reg_name] = wrapped
    return wrapped


def _make_wrapper(fn: Callable, reg_name: str) -> Callable:
    is_class = inspect.isclass(fn)
    target = fn.__init__ if is_class else fn
    try:
        signature = inspect.signature(target)
        param_names = {
            p.name
            for p in signature.parameters.values()
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
        }
        has_var_kw = any(
            p.kind == p.VAR_KEYWORD for p in signature.parameters.values()
        )
    except (TypeError, ValueError):
        param_names, has_var_kw = set(), True

    @functools.wraps(fn, updated=())
    def wrapper(*args, **kwargs):
        injected = _collect_bindings(reg_name)
        merged = dict(injected)
        merged.update(kwargs)  # explicit call-site kwargs win
        if not has_var_kw:
            unknown = set(merged) - param_names
            if unknown:
                raise ConfigError(
                    f"Unknown parameter(s) {sorted(unknown)} bound for "
                    f"configurable {reg_name!r}; accepts {sorted(param_names)}"
                )
        resolved = {k: _resolve_value(v) for k, v in merged.items()}
        with _REGISTRY.lock:
            record = _REGISTRY.operative.setdefault(reg_name, {})
            record.update(resolved)
        return fn(*args, **resolved)

    if is_class:
        # Classes: subclass so isinstance checks keep working while __init__
        # goes through injection.
        namespace = {
            "__init__": lambda self, *a, **kw: fn.__init__(
                self, *a, **_inject_for_class(reg_name, param_names, has_var_kw, kw)
            ),
            "__doc__": fn.__doc__,
        }
        subclass = type(fn.__name__, (fn,), namespace)
        subclass.__qualname__ = fn.__qualname__
        return subclass
    return wrapper


def _inject_for_class(reg_name, param_names, has_var_kw, kwargs):
    injected = _collect_bindings(reg_name)
    merged = dict(injected)
    merged.update(kwargs)
    if not has_var_kw:
        unknown = set(merged) - param_names
        if unknown:
            raise ConfigError(
                f"Unknown parameter(s) {sorted(unknown)} bound for "
                f"configurable {reg_name!r}; accepts {sorted(param_names)}"
            )
    resolved = {k: _resolve_value(v) for k, v in merged.items()}
    with _REGISTRY.lock:
        record = _REGISTRY.operative.setdefault(reg_name, {})
        record.update(resolved)
    return resolved


def _collect_bindings(reg_name: str) -> Dict[str, Any]:
    """Bindings for a name: unscoped, overlaid by active scopes innermost-last
    (gin scope semantics)."""
    with _REGISTRY.lock:
        out: Dict[str, Any] = {}
        for (bound_name, param), value in _REGISTRY.bindings.items():
            if bound_name == reg_name:
                out[param] = value
        for scope in _REGISTRY.scope_stack:
            scoped = f"{scope}/{reg_name}"
            for (bound_name, param), value in _REGISTRY.bindings.items():
                if bound_name == scoped:
                    out[param] = value
        return out


@contextlib.contextmanager
def config_scope(scope: str):
    """Activates scoped bindings: inside, `scope/name.param` bindings apply."""
    _REGISTRY.scope_stack.append(scope)
    try:
        yield
    finally:
        _REGISTRY.scope_stack.pop()


# -- value language -----------------------------------------------------------


class _Reference:
    """Deferred @configurable reference, optionally called at resolve time."""

    def __init__(self, name: str, call: bool, scope: Optional[str] = None):
        self.name = name
        self.call = call
        self.scope = scope

    def __repr__(self):
        prefix = f"{self.scope}/" if self.scope else ""
        return f"@{prefix}{self.name}" + ("()" if self.call else "")


class _Macro:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"%{self.name}"


def _resolve_value(value: Any) -> Any:
    if isinstance(value, _Macro):
        with _REGISTRY.lock:
            if value.name not in _REGISTRY.macros:
                raise ConfigError(f"Undefined macro %{value.name}")
            macro_value = _REGISTRY.macros[value.name]
        return _resolve_value(macro_value)
    if isinstance(value, _Reference):
        with _REGISTRY.lock:
            target = _REGISTRY.configurables.get(value.name)
        if target is None:
            raise ConfigError(
                f"Reference to unregistered configurable @{value.name}"
            )
        if not value.call:
            return target
        if value.scope:
            with config_scope(value.scope):
                return target()
        return target()
    if isinstance(value, list):
        return [_resolve_value(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_resolve_value(v) for v in value)
    if isinstance(value, dict):
        return {k: _resolve_value(v) for k, v in value.items()}
    return value


def _reference(body: str) -> _Reference:
    call = body.endswith("()")
    if call:
        body = body[:-2]
    scope = None
    if "/" in body:
        scope, body = body.rsplit("/", 1)
    return _Reference(body, call=call, scope=scope)


# A reference or a macro inside a container, outside string literals.
_TOKEN_RE = re.compile(
    r"@((?:[A-Za-z_][\w.]*/)*[A-Za-z_][\w.]*(?:\(\))?)|%([A-Za-z_][\w.]*)")
_STRING_RE = re.compile(r"'(?:\\.|[^'\\])*'" + r'|"(?:\\.|[^"\\])*"')
_REF_CALL, _MACRO_CALL = "__t2r_reference__", "__t2r_macro__"


def _mark_tokens(text: str) -> str:
    """`@name()` and `%NAME` outside strings as calls of marker functions
    that _ast_to_value turns back into references and macros."""

    def mark(match):
        if match.group(1) is not None:
            return f"{_REF_CALL}({match.group(1)!r})"
        return f"{_MACRO_CALL}({match.group(2)!r})"

    out, pos = [], 0
    for string in _STRING_RE.finditer(text):
        out.append(_TOKEN_RE.sub(mark, text[pos:string.start()]))
        out.append(string.group(0))
        pos = string.end()
    out.append(_TOKEN_RE.sub(mark, text[pos:]))
    return "".join(out)


def _parse_value(text: str) -> Any:
    text = text.strip()
    if text.startswith("@"):
        return _reference(text[1:])
    if text.startswith("%"):
        return _Macro(text[1:])
    # Containers may hold references/macros: parse via ast with a transform.
    try:
        node = ast.parse(_mark_tokens(text), mode="eval").body
        return _ast_to_value(node)
    except (SyntaxError, ValueError) as e:
        raise ConfigError(f"Cannot parse config value {text!r}: {e}") from e


def _ast_to_value(node: ast.AST) -> Any:
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in (_REF_CALL, _MACRO_CALL)):
        (arg,) = node.args
        if node.func.id == _REF_CALL:
            return _reference(arg.value)
        return _Macro(arg.value)
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.List):
        return [_ast_to_value(e) for e in node.elts]
    if isinstance(node, ast.Tuple):
        return tuple(_ast_to_value(e) for e in node.elts)
    if isinstance(node, ast.Dict):
        return {
            _ast_to_value(k): _ast_to_value(v)
            for k, v in zip(node.keys, node.values)
        }
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        operand = _ast_to_value(node.operand)
        return -operand
    if isinstance(node, ast.Name):
        # Bare names: gin treats e.g. True/False/None via constants; anything
        # else is an error surfaced here.
        raise ConfigError(f"Unquoted name {node.id!r} in config value")
    raise ConfigError(f"Unsupported config expression: {ast.dump(node)}")


# -- binding API --------------------------------------------------------------


def bind_parameter(target: str, value: Any) -> None:
    """bind_parameter('scope/name.param', value) — runtime override
    (reference uses gin.bind_parameter, utils/train_eval.py:544-546)."""
    if "." not in target:
        raise ConfigError(f"Binding target {target!r} must be name.param")
    name, param = target.rsplit(".", 1)
    with _REGISTRY.lock:
        _REGISTRY.bindings[(name, param)] = value


def bind_macro(name: str, value: Any) -> None:
    with _REGISTRY.lock:
        _REGISTRY.macros[name] = value


def query_parameter(target: str) -> Any:
    name, param = target.rsplit(".", 1)
    with _REGISTRY.lock:
        if (name, param) not in _REGISTRY.bindings:
            raise ConfigError(f"No binding for {target!r}")
        return _REGISTRY.bindings[(name, param)]


def get_configurable(name: str) -> Callable:
    with _REGISTRY.lock:
        if name not in _REGISTRY.configurables:
            raise ConfigError(f"Unknown configurable {name!r}")
        return _REGISTRY.configurables[name]


def clear_config(clear_constants: bool = True) -> None:
    with _REGISTRY.lock:
        _REGISTRY.bindings.clear()
        _REGISTRY.operative.clear()
        if clear_constants:
            _REGISTRY.macros.clear()


# -- config-file parsing ------------------------------------------------------

_LINE_RE = re.compile(r"^(?P<target>[\w./-]+(?:\.[\w]+)?)\s*=\s*(?P<value>.+)$")


def parse_config(text: str, base_dir: str = ".") -> None:
    """Parses gin-syntax config text into bindings/macros."""
    lines = text.splitlines()
    buffer = ""
    depth = 0
    for raw in lines:
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        buffer = (buffer + " " + line.strip()).strip() if buffer else line.strip()
        depth = (
            buffer.count("(") - buffer.count(")")
            + buffer.count("[") - buffer.count("]")
            + buffer.count("{") - buffer.count("}")
        )
        if depth > 0:
            continue
        statement, buffer = buffer, ""
        _parse_statement(statement, base_dir)
    if buffer:
        raise ConfigError(f"Unterminated config statement: {buffer!r}")


def _parse_statement(statement: str, base_dir: str) -> None:
    if statement.startswith("include"):
        match = re.match(r"include\s+['\"](.+)['\"]\s*$", statement)
        if not match:
            raise ConfigError(f"Malformed include: {statement!r}")
        path = match.group(1)
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        parse_config_file(path)
        return
    if statement.startswith("import"):
        # Side-effect imports registering configurables (gin parity).
        module = port_module(statement.split(None, 1)[1].strip())
        import importlib

        importlib.import_module(module)
        with _REGISTRY.lock:
            _REGISTRY.imports.append(module)
        return
    match = _LINE_RE.match(statement)
    if not match:
        raise ConfigError(f"Cannot parse config line: {statement!r}")
    target = match.group("target")
    value = _parse_value(match.group("value"))
    if "." in target:
        name, param = target.rsplit(".", 1)
        with _REGISTRY.lock:
            _REGISTRY.bindings[(name, param)] = value
    else:
        # MACRO = value
        with _REGISTRY.lock:
            _REGISTRY.macros[target] = value


_JAX_PACKAGE = "tensor2robot_tpu"
_PORT_PACKAGE = "tensor2robot_tpu_torch"
_FORBIDDEN_ROOTS = (_JAX_PACKAGE, "jax", "jaxlib", "flax", "optax", "orbax")


def port_module(module: str) -> str:
    """The module a config's `import` loads: `tensor2robot_tpu.<m>` is the
    port's `tensor2robot_tpu_torch.<m>`; any other module of the JAX
    package, or of JAX, raises ConfigError; the rest import as named."""
    root, _, rest = module.partition(".")
    if root == _JAX_PACKAGE and rest:
        return f"{_PORT_PACKAGE}.{rest}"
    if root in _FORBIDDEN_ROOTS:
        raise ConfigError(
            f"config imports {module!r}: the port never loads the JAX "
            f"package or JAX (name a module under {_JAX_PACKAGE}. to import "
            "its port)")
    return module


def parse_config_file(path: str) -> None:
    with open(path) as f:
        parse_config(f.read(), base_dir=os.path.dirname(path))


def parse_config_files_and_bindings(
    config_files: Optional[Sequence[str]] = None,
    bindings: Optional[Sequence[str]] = None,
) -> None:
    """The CLI entry (reference bin/run_t2r_trainer.py:30-32 pattern)."""
    for path in config_files or []:
        parse_config_file(path)
    for binding in bindings or []:
        parse_config(binding)


# -- operative config ---------------------------------------------------------


def operative_config_str() -> str:
    """The parameters every configurable actually received — the artifact
    proving what ran (gin operative-config parity)."""
    with _REGISTRY.lock:
        parts: List[str] = []
        for module in _REGISTRY.imports:
            parts.append(f"import {module}")
        if _REGISTRY.macros:
            for name, value in sorted(_REGISTRY.macros.items()):
                parts.append(f"{name} = {value!r}")
            parts.append("")
        for name in sorted(_REGISTRY.operative):
            for param, value in sorted(_REGISTRY.operative[name].items()):
                parts.append(f"{name}.{param} = {_format_value(value)}")
            parts.append("")
        return "\n".join(parts)


def _format_value(value: Any) -> str:
    if callable(value) and hasattr(value, "__name__"):
        return f"@{value.__name__}"
    return repr(value)


def save_operative_config(model_dir: str, filename: str = "operative_config.gin") -> str:
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, filename)
    with open(path, "w") as f:
        f.write(operative_config_str())
    return path
