"""Minimal C preprocessor for the restricted frontend: comments,
object-/function-like #define (cpp substitution order, literal
masking, ## token paste), #ifdef conditionals, #include "..." and the
COAST.h annotation macros.  The counterpart of
``coast_tpu/frontend/c_preproc.py``: host text work, unchanged.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from coast_tpu_torch.frontend.c_types import CLiftError


# ---------------------------------------------------------------------------
# Minimal preprocessing: the subset needs no system headers.
# ---------------------------------------------------------------------------

_COAST_MACROS = ("__DEFAULT_NO_xMR", "__DEFAULT_xMR", "__xMR", "__NO_xMR",
                 "__xMR_FN", "__NO_xMR_FN")

# Further COAST.h attribute macros: recorded and stripped so annotated
# sources PARSE (the annotations expand to __attribute__ in the real
# header, COAST.h:11-67); behaviors already designed away (ISRs,
# malloc/printf wrappers) surface later as loud refusals on the
# construct itself, not as parse errors on the macro token.
_COAST_STRIP_TOKENS = ("__xMR_FN_CALL", "__SKIP_FN_CALL",
                       "__COAST_VOLATILE", "__ISR_FUNC", "__xMR_RET_VAL",
                       "__xMR_PROT_LIB", "__xMR_ALL_AFTER_CALL",
                       "__COAST_NO_INLINE")
# Function-like COAST macros whose whole invocation line is a no-op
# declaration in the real header (wrapper registration).
_COAST_STRIP_CALLS = ("PRINTF_WRAPPER_REGISTER", "MALLOC_WRAPPER_REGISTER",
                      "__COAST_IGNORE_GLOBAL")

_PRELUDE = """
typedef unsigned int uint32_t;
typedef int int32_t;
typedef unsigned short uint16_t;
typedef short int16_t;
typedef unsigned char uint8_t;
typedef signed char int8_t;
"""


def _strip_comments(text: str) -> str:
    """Remove //... and /*...*/ outside string literals (pycparser wants
    preprocessed input)."""
    out = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        elif text.startswith("//", i):
            i = text.find("\n", i)
            i = n if i < 0 else i
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("\n" * text.count("\n", i, j))   # keep line numbers
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


def preprocess(text: str, include_dirs: Sequence[str] = (),
               defines: Optional[Dict[str, str]] = None,
               name_flags: Optional[Dict[str, bool]] = None,
               fdefines: Optional[Dict[str, Tuple[List[str], str]]] = None,
               ) -> Tuple[str, Dict[str, str], List[str], Dict[str, bool]]:
    """Strip/resolve the tiny preprocessor surface the benchmarks use.

    Returns (source, defines, coast_macros, name_flags).  ``#include
    "local.c"`` is inlined from ``include_dirs`` (the mm_common.c
    pattern) and SHARES the including file's ``#define`` table, exactly
    like cpp textual inclusion; ``#include <...>`` system headers are
    dropped (the prelude supplies the stdint names); object-like AND
    function-like ``#define``s substitute (continuation lines joined;
    arguments are paren-wrapped on substitution, which the benchmark
    macros -- ROTRIGHT, DBL_INT_ADD -- are written to tolerate).
    ``name_flags`` collects per-declaration scope annotations:
    ``uint32_t __xMR results[..]`` records ``{"results": True}`` (and
    ``__NO_xMR`` False) -- the identifier FOLLOWING the macro, matching
    the reference's declaration style (tests/mm_common/mm_tmr.c).
    """
    text = _strip_comments(text).replace("\\\n", " ")
    defines = {} if defines is None else defines
    fdefines = {} if fdefines is None else fdefines
    name_flags = {} if name_flags is None else name_flags
    annotations: List[str] = []
    out: List[str] = []

    def expand_fn(line: str) -> str:
        """Expand function-like macro calls with balanced-paren args."""
        for _ in range(8):                       # bounded nesting
            changed = False
            for name, (params, body) in fdefines.items():
                m = re.search(rf"\b{re.escape(name)}\s*\(", line)
                if not m:
                    continue
                start, i = m.start(), m.end()
                depth, args, cur = 1, [], ""
                while i < len(line) and depth:
                    ch = line[i]
                    if ch == "(":
                        depth += 1
                    elif ch == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    if depth == 1 and ch == ",":
                        args.append(cur)
                        cur = ""
                    else:
                        cur += ch
                    i += 1
                if depth:
                    raise CLiftError(
                        f"unbalanced macro call {name}(... in: {line!r}")
                args.append(cur)
                if not params:
                    args = [a for a in args if a.strip()]
                if len(args) != len(params):
                    raise CLiftError(
                        f"macro {name} expects {len(params)} args, "
                        f"got {len(args)} in: {line!r}")
                # Token paste FIRST (cpp order): a parameter adjacent to
                # ## substitutes its RAW argument (no parens, no prior
                # expansion), then the operator splices the tokens --
                # CHStone sha's `f##n(B,C,D)` / `CONST##n`.
                raw = {p: a.strip() for p, a in zip(params, args)}

                def paste(m):
                    l, r2 = m.group(1), m.group(2)
                    return raw.get(l, l) + raw.get(r2, r2)

                while re.search(r"\w+\s*##\s*\w+", body):
                    body = re.sub(r"(\w+)\s*##\s*(\w+)", paste, body,
                                  count=1)
                # SIMULTANEOUS parameter substitution with a function
                # replacement: sequential re.sub would re-substitute an
                # argument that mentions a later parameter's name, and a
                # string template would reinterpret backslashes in the
                # argument ('\n' in a char constant).  An argument that
                # is already one parenthesized unit is not re-wrapped
                # (_ANSI_ARGS_((void)) must yield (void), not ((void))).
                def wrap_arg(s: str) -> str:
                    s = s.strip()
                    if s.startswith("(") and s.endswith(")"):
                        depth = 0
                        for k, ch in enumerate(s):
                            if ch == "(":
                                depth += 1
                            elif ch == ")":
                                depth -= 1
                                if depth == 0 and k != len(s) - 1:
                                    break
                        else:
                            return s
                    return f"({s})"

                amap = {p: wrap_arg(a) for p, a in zip(params, args)}
                if amap:
                    pat = "|".join(rf"\b{re.escape(p)}\b" for p in amap)
                    sub = re.sub(pat, lambda m: amap[m.group(0)], body)
                else:
                    sub = body
                line = line[:start] + sub + line[i + 1:]
                changed = True
            if not changed:
                return line
        return line

    _LIT_RE = re.compile(r'"(?:[^"\\]|\\.)*"|\'(?:[^\'\\]|\\.)*\'')

    def expand(line: str) -> str:
        # String/char literals are masked out before substitution (cpp
        # never substitutes inside them -- a macro name appearing in a
        # printf format must survive) and restored after; literals
        # introduced BY an expansion are masked on the next pass.
        lits: List[str] = []

        def mask(m):
            lits.append(m.group(0))
            return f"\x01{len(lits) - 1}\x02"

        for _ in range(8):                       # rescan until stable
            line = _LIT_RE.sub(mask, line)
            before = line
            for name, val in defines.items():
                # Function replacement: a value containing backslashes
                # must not be reinterpreted as a regex template.
                line = re.sub(rf"\b{re.escape(name)}\b", lambda m: val,
                              line)
            line = expand_fn(line)
            if line == before:
                break
        return re.sub(r"\x01(\d+)\x02", lambda m: lits[int(m.group(1))],
                      line)

    def _paren_balance(s: str) -> int:
        s = _LIT_RE.sub("", s)
        return s.count("(") - s.count(")")

    # Conditional-inclusion stack: [taking, evaluable, satisfied].
    # #ifdef/#ifndef evaluate against the defines tables (motion's
    # global.h selects the _ANSI_ARGS_ variant this way); other #if
    # forms keep the legacy include-everything behavior
    # (evaluable=False), their #else/#elif branches included too.
    cond_stack: List[List[bool]] = []

    lines_in = text.splitlines()
    li = 0
    while li < len(lines_in):
        raw = lines_in[li]
        li += 1
        # A function-like macro call spanning lines (motion's
        # _ANSI_ARGS_((int *PMV, ...) prototypes): join until balanced.
        if (any(re.search(rf"\b{re.escape(n)}\s*\(", raw)
                for n in fdefines)
                and not raw.lstrip().startswith("#")):
            guard = 0
            while (_paren_balance(raw) > 0 and li < len(lines_in)
                   and guard < 100):
                raw += " " + lines_in[li]
                li += 1
                guard += 1
        line = raw
        stripped = line.strip()
        if stripped.startswith("#"):
            # cpp allows whitespace between # and the directive name
            # (global.h's `#   define _ANSI_ARGS_(x) x`).
            stripped = re.sub(r"^#\s+", "#", stripped)
        if stripped.startswith("#ifdef") or stripped.startswith("#ifndef"):
            m = re.match(r"#ifn?def\s+(\w+)", stripped)
            if m:
                known = (m.group(1) in defines or m.group(1) in fdefines)
                taking = (known if stripped.startswith("#ifdef")
                          else not known)
                cond_stack.append([taking, True, taking])
            else:
                cond_stack.append([True, False, True])
            continue
        if stripped.startswith("#if"):
            cond_stack.append([True, False, True])
            continue
        if stripped.startswith("#elif"):
            if cond_stack and cond_stack[-1][1]:
                if cond_stack[-1][2]:        # a branch was taken: skip rest
                    cond_stack[-1][0] = False
                else:                        # unknown #elif: legacy include
                    cond_stack[-1] = [True, False, True]
            continue
        if stripped.startswith("#else"):
            if cond_stack and cond_stack[-1][1]:
                cond_stack[-1][0] = not cond_stack[-1][2]
            continue
        if stripped.startswith("#endif"):
            if cond_stack:
                cond_stack.pop()
            continue
        if not all(e[0] for e in cond_stack):
            continue                          # skipped conditional branch
        if stripped.startswith("#include"):
            m = re.match(r'#include\s+"([^"]+)"', stripped)
            if m:
                fname = m.group(1)
                for d in include_dirs:
                    path = os.path.join(d, fname)
                    if os.path.exists(path):
                        if fname.endswith("COAST.h") or fname == "COAST.h":
                            break
                        with open(path) as f:
                            sub, _, subann, _ = preprocess(
                                f.read(), include_dirs, defines,
                                name_flags, fdefines)
                        annotations.extend(subann)
                        out.append(sub)
                        break
                else:
                    if not fname.endswith("COAST.h"):
                        raise CLiftError(
                            f'#include "{fname}" not found in '
                            f"{list(include_dirs)}")
            continue
        if stripped.startswith("#define"):
            fm = re.match(r"#define\s+(\w+)\(([^)]*)\)\s+(.+?)\s*$",
                          stripped)
            if fm:
                params = [p.strip() for p in fm.group(2).split(",")
                          if p.strip()]
                fdefines[fm.group(1)] = (params, fm.group(3))
                continue
            m = re.match(r"#define\s+(\w+)\s+(.+?)\s*$", stripped)
            if m:
                defines[m.group(1)] = expand(m.group(2))
                continue
            m = re.match(r"#define\s+(\w+)\s*$", stripped)
            if m:
                # Valueless define (SPARC-GCC.h's `#define INLINE`):
                # substitutes to nothing, and flips #ifdef decisions.
                defines[m.group(1)] = ""
            continue
        if stripped.startswith("#"):
            continue                      # #ifdef guards etc.: benign here
        # Expand BEFORE the annotation passes: a source-local alias like
        # `#define FUNCTION_TAG __xMR` must be recorded and stripped the
        # same as a literal __xMR (load_store.c's style).
        line = expand(line)
        # Per-declaration scope annotations.  Styles the reference corpus
        # uses: mid-declaration ``uint32_t __xMR name[..]`` (the token
        # after the macro is the name), prefix ``__xMR uint32_t name``
        # (the SECOND token is; the first is a type and resolves to
        # nothing), and trailing ``int foo() __xMR``.
        for m in re.finditer(r"\b(__NO_xMR|__xMR)\s+(\w+)(?:\s+(\w+))?",
                             line):
            flag = m.group(1) == "__xMR"
            name_flags.setdefault(m.group(2), flag)
            if m.group(3):
                name_flags.setdefault(m.group(3), flag)
        for m in re.finditer(r"\b(\w+)\s*\([^()]*\)\s*(__NO_xMR|__xMR)\b",
                             line):
            name_flags.setdefault(m.group(1), m.group(2) == "__xMR")
        # Record + strip COAST annotation macros and GCC attributes.
        for mac in _COAST_MACROS + _COAST_STRIP_TOKENS:
            if re.search(rf"\b{mac}\b", line):
                annotations.append(mac)
                line = re.sub(rf"\b{mac}\b", "", line)
        for mac in _COAST_STRIP_CALLS:
            if re.search(rf"\b{mac}\s*\(", line):
                annotations.append(mac)
                line = re.sub(rf"\b{mac}\s*\([^)]*\)\s*;?", "", line)
        line = re.sub(r"__attribute__\s*\(\(.*?\)\)", "", line)
        out.append(line)
    return "\n".join(out), defines, annotations, name_flags
