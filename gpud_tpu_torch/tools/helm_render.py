"""Pure-Python renderer for tpud's helm chart (no helm binary needed).

A CI image without a helm binary cannot check a chart, so this renders the chart's Go-template
subset well enough to YAML-parse the result and assert the shape — and
doubles as an operator sanity tool:

    python -m gpud_tpu_torch.tools.helm_render deployments/helm/tpud \\
        --set controlPlane.endpoint=https://cp --name myrelease

Supported template subset (the chart is deliberately kept within it; the
sync test fails loudly on anything else):
- ``{{ .Values.a.b }}`` / ``{{ .Release.Name }}`` / ``{{ . }}`` lookups
- ``{{- if PIPELINE }} ... {{- end }}`` (Go truthiness)
- ``{{- with PIPELINE }} ... {{- end }}`` (rebinds dot)
- ``{{- range PIPELINE }} ... {{- end }}`` (rebinds dot per element)
- ``{{ include "name" . }}`` of ``{{- define "name" -}}`` helpers
- pipe functions: default, quote, toYaml, nindent, indent, trunc,
  trimSuffix, printf (%s only)
- ``{{-``/``-}}`` whitespace trimming
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

_ACTION = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}", re.DOTALL)


class TemplateError(Exception):
    pass


def _tokenize(src: str) -> List[Tuple[str, str]]:
    """[(kind, payload)] where kind is 'text' or 'action'; whitespace
    trimming for {{- and -}} is applied to the adjacent text tokens."""
    out: List[Tuple[str, str]] = []
    pos = 0
    for m in _ACTION.finditer(src):
        text = src[pos : m.start()]
        if m.group(0).startswith("{{-"):
            text = text.rstrip(" \t")
            if text.endswith("\n"):
                text = text[:-1]
        out.append(("text", text))
        out.append(("action", m.group(1).strip()))
        pos = m.end()
        if m.group(0).endswith("-}}"):
            rest = src[pos:]
            stripped = rest.lstrip(" \t")
            if stripped.startswith("\n"):
                stripped = stripped[1:]
            pos = len(src) - len(stripped)
    out.append(("text", src[pos:]))
    return out


# -- pipeline evaluation ----------------------------------------------------

def _truthy(v: Any) -> bool:
    return bool(v)


def _lookup(path: str, ctx: Dict[str, Any], dot: Any) -> Any:
    if path == ".":
        return dot
    cur: Any = ctx if path.startswith(".Values") or path.startswith(".Release") or path.startswith(".Chart") else dot
    for part in path.lstrip(".").split("."):
        if part == "":
            continue
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            cur = getattr(cur, part, None)
        if cur is None:
            return None
    return cur


def _to_yaml(v: Any) -> str:
    import yaml

    return yaml.safe_dump(v, default_flow_style=False, sort_keys=False).rstrip("\n")


def _split_args(s: str) -> List[str]:
    """Split on spaces, respecting double-quoted strings."""
    return re.findall(r'"[^"]*"|\S+', s)


def _eval_term(term: str, ctx: Dict[str, Any], dot: Any, defines: Dict[str, str]) -> Any:
    args = _split_args(term)
    head = args[0]
    if head.startswith('"') and head.endswith('"'):
        return head[1:-1]
    if head == "include":
        name = args[1].strip('"')
        body = defines.get(name)
        if body is None:
            raise TemplateError(f"include of undefined template {name!r}")
        sub_dot = _lookup(args[2], ctx, dot) if len(args) > 2 and args[2] != "." else dot
        return _render(body, ctx, sub_dot, defines)
    if head == "toYaml":
        return _to_yaml(_eval_term(args[1], ctx, dot, defines))
    if head == "printf":
        fmt = args[1].strip('"')
        vals = [_eval_term(a, ctx, dot, defines) for a in args[2:]]
        return fmt.replace("%s", "{}").format(*vals)
    if head.startswith("."):
        return _lookup(head, ctx, dot)
    raise TemplateError(f"unsupported term {term!r}")


def _eval_pipeline(expr: str, ctx: Dict[str, Any], dot: Any, defines: Dict[str, str]) -> Any:
    stages = [s.strip() for s in expr.split("|")]
    val = _eval_term(stages[0], ctx, dot, defines)
    for stage in stages[1:]:
        args = _split_args(stage)
        fn = args[0]
        if fn == "default":
            dflt = args[1].strip('"')
            val = val if _truthy(val) else dflt
        elif fn == "quote":
            val = f'"{val}"'
        elif fn == "toYaml":
            val = _to_yaml(val)
        elif fn in ("nindent", "indent"):
            n = int(args[1])
            pad = " " * n
            val = "\n".join(pad + ln for ln in str(val).splitlines())
            if fn == "nindent":
                val = "\n" + val
        elif fn == "trunc":
            val = str(val)[: int(args[1])]
        elif fn == "trimSuffix":
            sfx = args[1].strip('"')
            val = str(val)
            if val.endswith(sfx):
                val = val[: -len(sfx)]
        else:
            raise TemplateError(f"unsupported pipe function {fn!r}")
    return val


# -- block-structured rendering ---------------------------------------------

def _find_block_end(tokens: List[Tuple[str, str]], start: int) -> int:
    """Index of the matching `end` for the block opened at tokens[start]."""
    depth = 1
    i = start + 1
    while i < len(tokens):
        kind, payload = tokens[i]
        if kind == "action":
            word = payload.split(None, 1)[0] if payload else ""
            if word in ("if", "with", "range", "define"):
                depth += 1
            elif word == "end":
                depth -= 1
                if depth == 0:
                    return i
        i += 1
    raise TemplateError("unbalanced block: missing {{ end }}")


def _render_tokens(
    tokens: List[Tuple[str, str]],
    ctx: Dict[str, Any],
    dot: Any,
    defines: Dict[str, str],
) -> str:
    out: List[str] = []
    i = 0
    while i < len(tokens):
        kind, payload = tokens[i]
        if kind == "text":
            out.append(payload)
            i += 1
            continue
        word = payload.split(None, 1)[0] if payload else ""
        if word in ("if", "with", "range"):
            expr = payload[len(word) :].strip()
            end = _find_block_end(tokens, i)
            body = tokens[i + 1 : end]
            val = _eval_pipeline(expr, ctx, dot, defines)
            if word == "if":
                if _truthy(val):
                    out.append(_render_tokens(body, ctx, dot, defines))
            elif word == "with":
                if _truthy(val):
                    out.append(_render_tokens(body, ctx, val, defines))
            else:  # range
                for item in val or []:
                    out.append(_render_tokens(body, ctx, item, defines))
            i = end + 1
        elif word == "define":
            # handled during preprocessing; skip the whole block here
            i = _find_block_end(tokens, i) + 1
        elif word == "end":
            raise TemplateError("unexpected {{ end }}")
        else:
            val = _eval_pipeline(payload, ctx, dot, defines)
            out.append("" if val is None else str(val))
            i += 1
    return "".join(out)


def _render(src: str, ctx: Dict[str, Any], dot: Any, defines: Dict[str, str]) -> str:
    return _render_tokens(_tokenize(src), ctx, dot, defines)


def _collect_defines(src: str, defines: Dict[str, str]) -> None:
    tokens = _tokenize(src)
    i = 0
    while i < len(tokens):
        kind, payload = tokens[i]
        if kind == "action" and payload.startswith("define"):
            name = payload.split(None, 1)[1].strip().strip('"')
            end = _find_block_end(tokens, i)
            # re-serialize the body tokens back to template source
            body: List[str] = []
            for k, p in tokens[i + 1 : end]:
                body.append(p if k == "text" else "{{ " + p + " }}")
            defines[name] = "".join(body)
            i = end + 1
        else:
            i += 1


def render_chart(
    chart_dir: str,
    release_name: str = "tpud",
    overrides: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """Render every template in the chart → {filename: rendered YAML}."""
    import yaml

    with open(os.path.join(chart_dir, "values.yaml"), "r", encoding="utf-8") as f:
        values = yaml.safe_load(f) or {}
    with open(os.path.join(chart_dir, "Chart.yaml"), "r", encoding="utf-8") as f:
        chart = yaml.safe_load(f) or {}
    for key, val in (overrides or {}).items():
        cur = values
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = yaml.safe_load(val)

    ctx = {
        "Values": values,
        "Release": {"Name": release_name, "Namespace": "default"},
        "Chart": chart,
    }
    tmpl_dir = os.path.join(chart_dir, "templates")
    defines: Dict[str, str] = {}
    sources: Dict[str, str] = {}
    for name in sorted(os.listdir(tmpl_dir)):
        with open(os.path.join(tmpl_dir, name), "r", encoding="utf-8") as f:
            src = f.read()
        _collect_defines(src, defines)
        if not name.endswith(".tpl"):
            sources[name] = src
    return {
        name: _render(src, ctx, ctx, defines) for name, src in sources.items()
    }


def main(argv: Optional[List[str]] = None) -> int:
    import yaml

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chart_dir")
    ap.add_argument("--name", default="tpud", help="release name")
    ap.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override a values key (dotted path)",
    )
    args = ap.parse_args(argv)
    overrides = dict(s.split("=", 1) for s in args.set)
    try:
        rendered = render_chart(args.chart_dir, args.name, overrides)
        # validate BEFORE printing so a template typo yields the clean
        # failure message, not partial output plus a traceback
        for name, body in rendered.items():
            list(yaml.safe_load_all(body))  # multi-document templates ok
    except (TemplateError, OSError, yaml.YAMLError) as e:
        print(f"render failed: {e}", file=sys.stderr)
        return 1
    for name, body in rendered.items():
        print(f"---\n# Source: {name}")
        print(body)
    return 0


if __name__ == "__main__":
    sys.exit(main())
