"""Statement/control-flow lowering for the restricted-C compiler:
the desugaring pre-pass (switch, deep breaks, run-once loops), the
forward-goto skip-flag rewrite, early returns, and the loop/branch
executors (scan/while/rotated-condition lowering).  Mixin methods of
_Compiler (c_lifter.py); split out in round 5.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from coast_tpu_torch.frontend import c_array as cnp
from coast_tpu_torch.frontend import loops
from coast_tpu_torch.frontend.c_types import (
    CLiftError, _NoPrintList, _Scope, _const_int, c_ast)


class _FlowMixin:
    """Statement-execution half of _Compiler."""

    def _replayable(self, fn):
        """``fn`` (a loop's body or condition) made to leave the
        compiler's state as ONE trace leaves it.  JAX traces a body once;
        the port records it once and then runs it for each iteration
        (and a nested static loop's body once per trip), so every call
        after the first starts from the first call's counter: the same
        transient names, slot ids and print-string entries each time."""
        start = []

        def run(*args):
            if start:
                self._tmp = start[0]
            else:
                start.append(self._tmp)
            return fn(*args)

        return run

    def _desugar_fn(self, fndef) -> None:
        """Memoized per-function AST pre-pass, run before execution and
        before the early-return rewrite:

        * ``switch`` -> evaluate-once + ``if``/``else if`` chain (the
          subset's switches are break/return-terminated, CHStone mips.c
          style; fallthrough refuses loudly);
        * ``do {B} while (C)`` -> ``B; while (C) {B}`` (the body AST is
          shared; execution is functional over it);
        * ``while (1)`` whose body always returns at its tail runs
          exactly once -> body inlined (mips.c's outer retry loop), so
          its printfs stay program outputs;
        * a string-only ``printf("...")`` under a branch/loop becomes a
          PRINT SLOT: ``__print_sel_k = <string id>`` with the slot
          initialized to -1 (never printed) and appended to the output
          surface when the function returns.  The reference's oracle IS
          stdout ("RESULT: PASS", unittest/cfg/full.yml) and which
          string prints is data -- a selected-constant output captures
          exactly that bit.  The id -> string table lands in
          ``region.meta['print_strings']``.  printf with VALUE arguments
          inside branches still refuses loudly (a traced per-iteration
          value cannot escape as a fixed output).
        """
        fid = id(fndef)
        if fid in self._desugared:
            return
        self._desugared.add(fid)
        slots = self._print_slots.setdefault(fid, [])
        temps = self._sw_temps.setdefault(fid, [])
        slot_by_node: Dict[int, Tuple[str, int]] = {}

        def as_items(node) -> list:
            if node is None:
                return []
            if isinstance(node, c_ast.Compound):
                return list(node.block_items or [])
            return [node]

        def ends_in_return(items) -> bool:
            if not items:
                return False
            last = items[-1]
            if isinstance(last, c_ast.Return):
                return True
            if isinstance(last, c_ast.Compound):
                return ends_in_return(as_items(last))
            if isinstance(last, c_ast.If) and last.iffalse is not None:
                return (ends_in_return(as_items(last.iftrue))
                        and ends_in_return(as_items(last.iffalse)))
            return False

        def loose_break(items) -> bool:
            """A break/continue that would bind to the statement being
            flattened (not to a nested loop of its own)."""
            for s in items:
                if isinstance(s, (c_ast.Break, c_ast.Continue)):
                    return True
                if isinstance(s, (c_ast.While, c_ast.For, c_ast.DoWhile,
                                  c_ast.Switch)):
                    continue
                if isinstance(s, c_ast.Compound):
                    if loose_break(as_items(s)):
                        return True
                elif isinstance(s, c_ast.If):
                    if (loose_break(as_items(s.iftrue))
                            or loose_break(as_items(s.iffalse))):
                        return True
            return False

        def slot_for(stmt) -> Tuple[str, int]:
            sid = id(stmt)
            if sid not in slot_by_node:
                text = stmt.args.exprs[0].value[1:-1]
                self.print_strings.append(
                    text.encode("utf-8").decode("unicode_escape"))
                k = len(self.print_strings) - 1
                slot_by_node[sid] = (f"__print_sel_{k}", k)
                slots.append(slot_by_node[sid])
            return slot_by_node[sid]

        def xform_block(node, in_branch: bool):
            items = []
            for s in as_items(node):
                items.extend(xform(s, in_branch))
            return c_ast.Compound(items, getattr(node, "coord", None))

        def desugar_switch(sw) -> list:
            body_items = as_items(sw.stmt)
            if isinstance(sw.cond, (c_ast.ID, c_ast.Constant)):
                ctrl, pre = sw.cond, []
            else:
                nm = f"__sw_{len(temps)}"
                temps.append(nm)
                ctrl = c_ast.ID(nm, sw.cond.coord)
                pre = [c_ast.Assignment("=", c_ast.ID(nm, sw.cond.coord),
                                        sw.cond, sw.cond.coord)]
            groups: list = []          # (conds | None-for-default, stmts)
            pending: list = []
            pending_default = False
            for it in body_items:
                if isinstance(it, c_ast.Case):
                    pending.append(it.expr)
                    stmts = list(it.stmts or [])
                elif isinstance(it, c_ast.Default):
                    pending_default = True
                    stmts = list(it.stmts or [])
                else:
                    raise CLiftError(
                        f"unsupported statement between switch cases at "
                        f"{getattr(it, 'coord', '?')}")
                if not stmts:
                    continue                      # label stacking
                if pending_default and pending:
                    raise CLiftError(
                        f"case labels stacked with default at {it.coord} "
                        "are not supported; restructure")
                groups.append((None if pending_default else list(pending),
                               stmts, it.coord))
                pending, pending_default = [], False
            # Validate break/return termination (fallthrough refuses);
            # the FINAL group may simply fall out of the switch.
            cleaned = []
            for gi, (conds, stmts, coord) in enumerate(groups):
                if isinstance(stmts[-1], c_ast.Break):
                    stmts = stmts[:-1]
                elif not ends_in_return(stmts) and gi != len(groups) - 1:
                    raise CLiftError(
                        f"switch case at {coord} falls through; add "
                        "break/return (fallthrough is outside the subset)")
                cleaned.append((conds, stmts, coord))
            default_body = None
            chain_groups = []
            for conds, stmts, coord in cleaned:
                body = xform_block(c_ast.Compound(stmts, coord), True)
                if conds is None:
                    default_body = body
                else:
                    chain_groups.append((conds, body))
            node = default_body
            for conds, body in reversed(chain_groups):
                cond_expr = None
                for cexpr in conds:
                    eq = c_ast.BinaryOp("==", ctrl, cexpr, sw.coord)
                    cond_expr = (eq if cond_expr is None else
                                 c_ast.BinaryOp("||", cond_expr, eq,
                                                sw.coord))
                node = c_ast.If(cond_expr, body, node, sw.coord)
            out_sw = pre + ([node] if node is not None else [])
            # MID-CASE breaks (beyond the stripped terminators) exit the
            # SWITCH, not any enclosing loop: lower them as a forward
            # goto to a label right after the if-chain, BEFORE any
            # enclosing loop's deep-break pass could misbind them.
            swend = None

            def rb(s):
                nonlocal swend
                if isinstance(s, c_ast.Break):
                    if swend is None:
                        swend = f"__swend{self._tmp}"
                        self._tmp += 1
                    return c_ast.Goto(swend, s.coord)
                if isinstance(s, (c_ast.While, c_ast.For, c_ast.DoWhile,
                                  c_ast.Switch)):
                    return s                     # inner construct's own
                if isinstance(s, c_ast.If):
                    return c_ast.If(
                        s.cond,
                        rb(s.iftrue) if s.iftrue is not None else None,
                        rb(s.iffalse) if s.iffalse is not None else None,
                        s.coord)
                if isinstance(s, c_ast.Compound):
                    return c_ast.Compound(
                        [rb(x) for x in (s.block_items or [])], s.coord)
                return s

            out_sw = [rb(s) for s in out_sw]
            if swend is not None:
                out_sw.append(c_ast.Label(
                    swend, c_ast.EmptyStatement(sw.coord), sw.coord))
            return out_sw

        def is_break_if(s) -> bool:
            if not isinstance(s, c_ast.If) or s.iffalse is not None:
                return False
            b = (s.iftrue.block_items or []
                 if isinstance(s.iftrue, c_ast.Compound) else [s.iftrue])
            return len(b) == 1 and isinstance(b[0], c_ast.Break)

        def lower_deep_breaks(loop) -> list:
            """Breaks beyond the `if (c) break;` idiom (jpeg's
            `if (s) { if ((k += n) >= 64) break; ... }`) lower through
            the goto machinery: break -> goto __brkN with the label
            right after the loop."""
            lbl = None

            def replace(s, top):
                nonlocal lbl
                if isinstance(s, c_ast.Break):
                    if top:
                        return s                 # the direct idiom's own
                    if lbl is None:
                        lbl = f"__brk{self._tmp}"
                        self._tmp += 1
                    return c_ast.Goto(lbl, s.coord)
                if isinstance(s, (c_ast.While, c_ast.For, c_ast.DoWhile,
                                  c_ast.Switch)):
                    return s                     # inner loop owns breaks
                if isinstance(s, c_ast.If):
                    if top and is_break_if(s):
                        return s
                    return c_ast.If(
                        s.cond,
                        replace(s.iftrue, False)
                        if s.iftrue is not None else None,
                        replace(s.iffalse, False)
                        if s.iffalse is not None else None, s.coord)
                if isinstance(s, c_ast.Compound):
                    return c_ast.Compound(
                        [replace(x, top) for x in as_items(s)], s.coord)
                return s

            items2 = as_items(loop.stmt)
            new_items = []
            for k, s in enumerate(items2):
                if isinstance(s, c_ast.Break) and k == len(items2) - 1:
                    new_items.append(s)          # run-once trailing break
                else:
                    new_items.append(replace(s, True))
            body2 = c_ast.Compound(new_items, loop.coord)
            if isinstance(loop, c_ast.For):
                new_loop = c_ast.For(loop.init, loop.cond, loop.next,
                                     body2, loop.coord)
            else:
                new_loop = c_ast.While(loop.cond, body2, loop.coord)
            if lbl is None:
                return [new_loop]
            return [new_loop,
                    c_ast.Label(lbl, c_ast.EmptyStatement(loop.coord),
                                loop.coord)]

        def xform(stmt, in_branch: bool) -> list:
            if isinstance(stmt, c_ast.Switch):
                return desugar_switch(stmt)
            if isinstance(stmt, c_ast.DoWhile):
                body = xform_block(stmt.stmt, True)
                if loose_break(as_items(body)):
                    raise CLiftError(
                        f"break/continue in do-while body at {stmt.coord} "
                        "is outside the subset; restructure")
                return [body, c_ast.While(stmt.cond, body, stmt.coord)]
            if isinstance(stmt, c_ast.While):
                body = xform_block(stmt.stmt, True)
                if (_const_int(stmt.cond) and ends_in_return(as_items(body))
                        and not loose_break(as_items(body))):
                    # while(1) whose body always returns: exactly one
                    # iteration -- inline it.
                    return as_items(body)
                return [c_ast.While(stmt.cond, body, stmt.coord)]
            if isinstance(stmt, c_ast.For):
                body = xform_block(stmt.stmt, True)
                return lower_deep_breaks(
                    c_ast.For(stmt.init, stmt.cond, stmt.next, body,
                              stmt.coord))
            if isinstance(stmt, c_ast.If):
                t = (xform_block(stmt.iftrue, True)
                     if stmt.iftrue is not None else None)
                f = (xform_block(stmt.iffalse, True)
                     if stmt.iffalse is not None else None)
                return [c_ast.If(stmt.cond, t, f, stmt.coord)]
            if isinstance(stmt, c_ast.Compound):
                return [xform_block(stmt, in_branch)]
            if in_branch and self._string_only_printf(stmt):
                nm, k = slot_for(stmt)
                return [c_ast.Assignment(
                    "=", c_ast.ID(nm, stmt.coord),
                    c_ast.Constant("int", str(k), stmt.coord), stmt.coord)]
            return [stmt]

        body = xform_block(fndef.body, False)
        fndef.body = self._rewrite_gotos(body, temps)

    def _rewrite_gotos(self, body, temps) -> "c_ast.Compound":
        """Lower FORWARD gotos into skip flags, per enclosing compound:

          goto L;   ->  __goto_L = 1;  (+ exit any FOR loops between)
          L: stmt   ->  __goto_L = 0; <stmt guarded like the rest>

        A label lives at the top level of SOME compound (the function
        body, a loop body, a branch); its gotos may sit anywhere below
        that compound, including inside nested FOR loops (jpeg's
        id_found search: the loop gains a flag-conditional break, and
        the in-loop statements after the jump run under the no-flags
        guard -- one masked partial iteration, no effects).  Statements
        of the label's compound between the goto point and the label
        run under ``if ((flagA | flagB | ...) == 0)`` -- the
        early-return discipline applied to jumps.  Refused loudly:
        backward gotos, gotos escaping while/do-while loops, unknown
        labels."""

        def goto_names(n) -> List[str]:
            out: List[str] = []

            class V(c_ast.NodeVisitor):
                def visit_Goto(v, nn):
                    out.append(nn.name)

            if n is not None:
                V().visit(n)
            return out

        if not goto_names(body):
            return body

        flag: Dict[str, str] = {}

        def flag_for(name: str) -> str:
            if name not in flag:
                flag[name] = f"__goto_{name}"
                temps.append(flag[name])
            return flag[name]

        def no_flags(names, coord):
            expr = None
            for L in names:
                e = c_ast.ID(flag_for(L), coord)
                expr = e if expr is None else c_ast.BinaryOp("|", expr, e,
                                                             coord)
            return c_ast.BinaryOp("==", expr, c_ast.Constant("int", "0"),
                                  coord)

        def as_items(node):
            if node is None:
                return []
            if isinstance(node, c_ast.Compound):
                return list(node.block_items or [])
            return [node]

        def rewrite(stmt, active):
            """Replace active gotos under ``stmt``; loops crossed by a
            jump gain guard+break discipline.  Returns the new stmt."""
            hit = [g for g in goto_names(stmt) if g in active]
            if not hit:
                return stmt
            if isinstance(stmt, c_ast.Goto):
                return c_ast.Assignment(
                    "=", c_ast.ID(flag_for(stmt.name), stmt.coord),
                    c_ast.Constant("int", "1", stmt.coord), stmt.coord)
            if isinstance(stmt, c_ast.Compound):
                return c_ast.Compound(
                    seq_guard(as_items(stmt), active, stmt.coord),
                    stmt.coord)
            if isinstance(stmt, c_ast.If):
                return c_ast.If(
                    stmt.cond,
                    rewrite(stmt.iftrue, active)
                    if stmt.iftrue is not None else None,
                    rewrite(stmt.iffalse, active)
                    if stmt.iffalse is not None else None,
                    stmt.coord)
            if isinstance(stmt, c_ast.For):
                items2 = seq_guard(as_items(stmt.stmt), active, stmt.coord)
                esc = sorted({g for g in goto_names(stmt.stmt)
                              if g in active})
                brk = c_ast.If(
                    c_ast.BinaryOp("==", no_flags(esc, stmt.coord),
                                   c_ast.Constant("int", "0", stmt.coord),
                                   stmt.coord),
                    c_ast.Break(stmt.coord), None, stmt.coord)
                return c_ast.For(stmt.init, stmt.cond, stmt.next,
                                 c_ast.Compound(items2 + [brk],
                                                stmt.coord), stmt.coord)
            if isinstance(stmt, (c_ast.While, c_ast.DoWhile)):
                raise CLiftError(
                    f"goto escaping a while/do-while at {stmt.coord} is "
                    "outside the modeled envelope; restructure")
            if isinstance(stmt, c_ast.Label):
                return c_ast.Label(stmt.name, rewrite(stmt.stmt, active),
                                   stmt.coord)
            raise CLiftError(
                f"goto in unsupported construct {type(stmt).__name__} at "
                f"{getattr(stmt, 'coord', '?')}")

        def seq_guard(stmts, active, coord):
            """Within a compound below the label level: statements after
            a goto point run under the no-flags guard."""
            out = []
            for k, s in enumerate(stmts):
                hit = [g for g in goto_names(s) if g in active]
                if not hit:
                    out.append(s)
                    continue
                out.append(rewrite(s, active))
                rest = seq_guard(stmts[k + 1:], active, coord)
                if rest:
                    wrap = c_ast.If(
                        no_flags(sorted(active), coord),
                        c_ast.Compound(rest, coord), None, coord)
                    self._synth_reason[id(wrap)] = "after a goto point"
                    out.append(wrap)
                return out
            return out

        def process(items, coord):
            """Handle labels at THIS compound level (recursing into
            nested compounds for deeper labels first)."""
            # Recurse structurally so deeper compounds resolve their own
            # label/goto pairs before this level's flags apply.
            def descend(s):
                if isinstance(s, c_ast.Compound):
                    return c_ast.Compound(
                        process(as_items(s), s.coord), s.coord)
                if isinstance(s, c_ast.If):
                    return c_ast.If(
                        s.cond,
                        descend(s.iftrue) if s.iftrue is not None
                        else None,
                        descend(s.iffalse) if s.iffalse is not None
                        else None, s.coord)
                if isinstance(s, (c_ast.For, c_ast.While, c_ast.DoWhile)):
                    body2 = c_ast.Compound(
                        process(as_items(s.stmt), s.coord), s.coord)
                    if isinstance(s, c_ast.For):
                        return c_ast.For(s.init, s.cond, s.next, body2,
                                         s.coord)
                    if isinstance(s, c_ast.While):
                        return c_ast.While(s.cond, body2, s.coord)
                    return c_ast.DoWhile(s.cond, body2, s.coord)
                if isinstance(s, c_ast.Label):
                    return c_ast.Label(s.name, descend(s.stmt), s.coord)
                return s

            items = [descend(s) for s in items]
            labels_here = {it.name: k for k, it in enumerate(items)
                           if isinstance(it, c_ast.Label)}
            if not labels_here:
                return items
            active = set(labels_here)
            # Forward check at this level.
            for k, it in enumerate(items):
                holder = it.stmt if isinstance(it, c_ast.Label) else it
                for g in goto_names(holder):
                    if g in labels_here and labels_here[g] <= k:
                        raise CLiftError(
                            f"backward goto {g!r} is outside the "
                            "modeled envelope (forward jumps only)")
            out: List[object] = []
            seen_goto = False
            for k_i, it in enumerate(items):
                if (seen_goto and isinstance(it, c_ast.Break)
                        and k_i == len(items) - 1):
                    # A trailing break (the run-once while(1) idiom) is
                    # reached on every path: forward-only jumps mean all
                    # this level's labels precede it, and each label
                    # resets its flag -- so by here every guard passes.
                    # It must also STAY a syntactic Break, or
                    # _exec_while no longer recognizes the idiom and the
                    # loop falls to the dynamic-while lowering.
                    out.append(it)
                    continue
                if isinstance(it, c_ast.Label) and it.name in active:
                    out.append(c_ast.Assignment(
                        "=", c_ast.ID(flag_for(it.name), it.coord),
                        c_ast.Constant("int", "0", it.coord), it.coord))
                    inner = rewrite(it.stmt, active)
                    wrap = c_ast.If(no_flags(sorted(active), it.coord),
                                    inner, None, it.coord)
                    self._synth_reason[id(wrap)] = "after a goto point"
                    out.append(wrap)
                    seen_goto = seen_goto or bool(
                        [g for g in goto_names(it.stmt) if g in active])
                    continue
                if seen_goto:
                    inner = rewrite(it, active)
                    wrap = c_ast.If(
                        no_flags(sorted(active),
                                 getattr(it, "coord", None)),
                        inner, None, getattr(it, "coord", None))
                    self._synth_reason[id(wrap)] = "after a goto point"
                    out.append(wrap)
                else:
                    out.append(rewrite(it, active))
                    seen_goto = seen_goto or bool(
                        [g for g in goto_names(it) if g in active])
            return out

        new_items = process(as_items(body), body.coord)
        stray = goto_names(c_ast.Compound(new_items, body.coord))
        if stray:
            raise CLiftError(
                f"goto to unknown/backward label(s) {sorted(set(stray))}; "
                "only forward jumps to a label in an enclosing compound "
                "are modeled")
        return c_ast.Compound(new_items, body.coord)


    @staticmethod
    def _has_return(node) -> bool:
        found = []

        class V(c_ast.NodeVisitor):
            def visit_Return(v, n):
                found.append(n)

        V().visit(node)
        return bool(found)

    def _rewrite_early_returns(self, fndef):
        """Lower structured early returns to a carried flag pair.

        ``return E`` anywhere becomes ``if (!__ret_set) { __ret_val = E;
        __ret_set = 1; }``; every statement after a return-containing
        one runs under ``if (!__ret_set)``; every loop whose subtree
        returns gains ``&& !__ret_set`` in its condition with the
        for-next moved into the body under the same guard (the exact
        discipline of the break lowering, applied function-wide) -- so
        ``if (hash[i] != golden[i]) return 1;`` inside a scan loop
        (checkGolden, sha256_common_tmr.c:191-198) exits with C's
        semantics.  Loop conditions become PURE carried variables primed
        before the loop and re-evaluated at the end of each body under
        the guard -- C's return exits WITHOUT re-testing the condition,
        so a side-effecting condition must not run on the returning
        exit.  Returns (new_body_items, set_name, val_name, synth_names)
        where synth_names are locals the caller must pre-create, or
        (None, None, None, None) when the body has no early return."""
        items = list(fndef.body.block_items or [])
        early = any(self._has_return(s) for s in items[:-1]) or (
            items and not isinstance(items[-1], c_ast.Return)
            and self._has_return(items[-1]))
        if not early:
            return None, None, None, None
        set_n = f"__ret_set{self._tmp}"
        val_n = f"__ret_val{self._tmp}"
        self._tmp += 1
        synth_names = [set_n, val_n]
        not_set = lambda coord: c_ast.BinaryOp(  # noqa: E731
            "==", c_ast.ID(set_n), c_ast.Constant("int", "0"), coord)

        def ret_to_set(n):
            expr = n.expr if n.expr is not None else c_ast.Constant(
                "int", "0")
            body = c_ast.Compound([
                c_ast.Assignment("=", c_ast.ID(val_n), expr, n.coord),
                c_ast.Assignment("=", c_ast.ID(set_n),
                                 c_ast.Constant("int", "1"), n.coord),
            ], n.coord)
            return c_ast.If(not_set(n.coord), body, None, n.coord)

        def xform(s):
            """Transform ONE statement in place-ish; returns new stmt."""
            if isinstance(s, c_ast.Return):
                return ret_to_set(s)
            if not self._has_return(s):
                return s
            if isinstance(s, c_ast.Compound):
                return c_ast.Compound(seq(list(s.block_items or [])),
                                      s.coord)
            if isinstance(s, c_ast.If):
                return c_ast.If(
                    s.cond,
                    xform(s.iftrue) if s.iftrue is not None else None,
                    xform(s.iffalse) if s.iffalse is not None else None,
                    s.coord)
            if isinstance(s, (c_ast.For, c_ast.While)):
                cond = getattr(s, "cond", None)
                guard = not_set(s.coord)
                body_items = (list(s.stmt.block_items or [])
                              if isinstance(s.stmt, c_ast.Compound)
                              else [s.stmt])
                body_items = seq(body_items)
                nxt = getattr(s, "next", None)
                if nxt is not None:
                    body_items.append(
                        c_ast.If(not_set(s.coord), nxt, None, s.coord))
                # Pure carried condition: primed before the loop,
                # re-evaluated (effects included) at the body end under
                # the !set guard so the returning exit never re-runs it.
                cnd = f"__cnd{self._tmp}"
                self._tmp += 1
                synth_names.append(cnd)
                pre = []
                init = getattr(s, "init", None)
                if init is not None:
                    pre.append(init)
                if cond is not None:
                    cond_val = c_ast.BinaryOp(
                        "!=", cond, c_ast.Constant("int", "0"), s.coord)
                    prime = c_ast.If(
                        guard,
                        c_ast.Assignment("=", c_ast.ID(cnd), cond_val,
                                         s.coord),
                        None, s.coord)
                    body_items.append(c_ast.Assignment(
                        "=", c_ast.ID(cnd), c_ast.Constant("int", "0"),
                        s.coord))
                    body_items.append(c_ast.If(
                        guard,
                        c_ast.Assignment("=", c_ast.ID(cnd), cond_val,
                                         s.coord),
                        None, s.coord))
                else:
                    prime = c_ast.Assignment(
                        "=", c_ast.ID(cnd), guard, s.coord)
                    body_items.append(c_ast.Assignment(
                        "=", c_ast.ID(cnd), guard, s.coord))
                pre.append(c_ast.Assignment(
                    "=", c_ast.ID(cnd), c_ast.Constant("int", "0"),
                    s.coord))
                pre.append(prime)
                new_body = c_ast.Compound(body_items, s.coord)
                loop = c_ast.For(None, c_ast.ID(cnd), None, new_body,
                                 s.coord)
                return c_ast.Compound(pre + [loop], s.coord)
            raise CLiftError(
                f"return in unsupported construct "
                f"{type(s).__name__} at {getattr(s, 'coord', '?')}")

        def seq(stmts):
            out = []
            for k, s in enumerate(stmts):
                if not self._has_return(s):
                    out.append(s)
                    continue
                out.append(xform(s))
                rest = seq(stmts[k + 1:])
                if rest:
                    wrap = c_ast.If(
                        not_set(getattr(s, "coord", None)),
                        c_ast.Compound(rest, getattr(s, "coord", None)),
                        None, getattr(s, "coord", None))
                    self._synth_reason[id(wrap)] = \
                        "after an early-return point"
                    out.append(wrap)
                return out
            return out

        return seq(items), set_n, val_n, synth_names

    def _rewrite_breaks(self, stmt, sc: _Scope):
        """Lower mid-loop conditional breaks (``if (c) break;``) to a
        carried break flag: the loop condition gains ``&& !brk`` and
        every statement after the break point runs under ``if (!brk)``,
        so the exit is exact -- same iteration count, same final state
        as the C program (sha256_tmr.c's for-100 early exit; the
        quicksort error-break idiom).  Returns a rewritten For (or the
        original when the body has no breaks).  Breaks in any other
        position refuse loudly; breaks inside NESTED loops belong to
        those loops and are left alone."""
        items = (list(stmt.stmt.block_items or [])
                 if isinstance(stmt.stmt, c_ast.Compound) else [stmt.stmt])
        if not any(self._count_breaks(s) for s in items
                   if not isinstance(s, (c_ast.While, c_ast.For))):
            return stmt
        brk = f"__brk{self._tmp}"
        self._tmp += 1
        sc.locals[brk] = cnp.int32(0)

        def is_break_if(s):
            """``if (c) break;`` / ``if (c) { break; }`` with no else."""
            if not isinstance(s, c_ast.If) or s.iffalse is not None:
                return False
            body = (s.iftrue.block_items or []
                    if isinstance(s.iftrue, c_ast.Compound) else [s.iftrue])
            return len(body) == 1 and isinstance(body[0], c_ast.Break)

        def rewrite(seq):
            out = []
            for k, s in enumerate(seq):
                if isinstance(s, (c_ast.While, c_ast.For)):
                    out.append(s)          # inner loop owns its breaks
                    continue
                if is_break_if(s):
                    set_brk = c_ast.Assignment(
                        "=", c_ast.ID(brk),
                        c_ast.Constant("int", "1"), s.coord)
                    out.append(c_ast.If(s.cond, set_brk, None, s.coord))
                    rest = rewrite(seq[k + 1:])
                    if rest:
                        guard = c_ast.BinaryOp(
                            "==", c_ast.ID(brk),
                            c_ast.Constant("int", "0"), s.coord)
                        wrap = c_ast.If(
                            guard, c_ast.Compound(rest, s.coord), None,
                            s.coord)
                        self._synth_reason[id(wrap)] = \
                            "after a mid-loop break point"
                        out.append(wrap)
                    return out
                if self._count_breaks(s):
                    raise CLiftError(
                        f"break in unsupported position at "
                        f"{getattr(s, 'coord', '?')}; only the "
                        "'if (cond) break;' idiom is lowered")
                out.append(s)
            return out

        body_stmts = rewrite(items)
        not_brk = c_ast.BinaryOp("==", c_ast.ID(brk),
                                 c_ast.Constant("int", "0"), stmt.coord)
        # C does not run the increment on the broken-out iteration: move
        # the next-expression into the body under the !brk guard (an If
        # STATEMENT, so its side effects are genuinely masked -- a
        # ternary would evaluate both arms under tracing).
        if stmt.next is not None:
            body_stmts.append(c_ast.If(not_brk, stmt.next, None,
                                       stmt.coord))
        # The loop condition becomes a PURE carried variable: C's break
        # exits WITHOUT re-testing the condition, so a side-effecting
        # condition (while (g--)) must not be evaluated on the
        # broken-out exit.  The variable is primed here (the pre-loop
        # test, effects apply once) and re-evaluated at the END of the
        # body under the !brk guard.
        cnd = f"__cnd{self._tmp}"
        self._tmp += 1
        sc.locals[cnd] = cnp.int32(0)
        if stmt.cond is not None:
            cond_val = c_ast.BinaryOp("!=", stmt.cond,
                                      c_ast.Constant("int", "0"),
                                      stmt.coord)
            self._exec_stmt(c_ast.Assignment("=", c_ast.ID(cnd),
                                             cond_val, stmt.coord), sc)
            body_stmts.append(c_ast.Assignment(
                "=", c_ast.ID(cnd), c_ast.Constant("int", "0"),
                stmt.coord))
            body_stmts.append(c_ast.If(
                not_brk,
                c_ast.Assignment("=", c_ast.ID(cnd), cond_val,
                                 stmt.coord),
                None, stmt.coord))
        else:
            self._exec_stmt(c_ast.Assignment(
                "=", c_ast.ID(cnd), c_ast.Constant("int", "1"),
                stmt.coord), sc)
            body_stmts.append(c_ast.Assignment(
                "=", c_ast.ID(cnd), not_brk, stmt.coord))
        new_body = c_ast.Compound(body_stmts, stmt.stmt.coord)
        return c_ast.For(None, c_ast.ID(cnd), None, new_body, stmt.coord)

    @staticmethod
    def _contains_printf(node) -> bool:
        found: List[object] = []

        class V(c_ast.NodeVisitor):
            def visit_FuncCall(v, n):
                if isinstance(n.name, c_ast.ID) and n.name.name == "printf":
                    found.append(n)
                v.generic_visit(n)

        V().visit(node)
        return bool(found)

    def _exec_for(self, stmt, sc: _Scope):
        if stmt.init is not None:
            self._exec_stmt(stmt.init, sc)
        # PRINT-ONLY loop (aes.c dumping the ciphertext bytes): a loop
        # whose body writes nothing (beyond print slots) but prints
        # per-iteration values.  Its observable IS the printed sequence,
        # so it unrolls at trace time under a concrete bound -- each
        # iteration's printf appends one program output.  A traced bound
        # refuses loudly (the output arity must be static).
        if (stmt.cond is not None and stmt.stmt is not None
                and self._contains_printf(stmt.stmt)
                and all(n.startswith("__print_sel_")
                        or n in ("__print_buf", "__print_cnt")
                        for n in self._assigned_names(stmt.stmt))):
            for _ in range(4096):
                live = (self._const_eval(stmt.cond, sc)
                        if not self._has_effects(stmt.cond) else None)
                if live is None:
                    raise CLiftError(
                        f"print-only loop at {stmt.coord} has a traced "
                        "bound; the number of printed outputs must be "
                        "static")
                if not live:
                    return None
                ret = self._exec_block(stmt.stmt, sc)
                if ret is not None:
                    raise CLiftError(
                        f"return inside a loop at {stmt.coord}; "
                        "restructure")
                if stmt.next is not None:
                    self.eval(stmt.next, sc)
            raise CLiftError(
                f"print-only loop at {stmt.coord} exceeds the 4096-"
                "iteration unroll bound")
        stmt = self._rewrite_breaks(stmt, sc)
        self._preseat(stmt, sc)
        carry_names = self._loop_carry(stmt, sc)

        def pack():
            return tuple(sc.read_binding(n) for n in carry_names)

        def unpack(sub_sc, vals):
            for n, v in zip(carry_names, vals):
                sub_sc.write_binding(n, v)
                sub_sc.consts.pop(n, None)   # traced write: value unknown

        trip = self._static_trip(stmt, sc)
        if trip is not None:
            def body(carry, _):
                sub = sc.fork(no_print_at=stmt.coord)
                # Per-iteration prints become STACKED scan outputs (one
                # [trip]-shaped observable per printed value, dfmul's
                # per-vector diagnostic line); the arity is fixed by the
                # single body trace.  Branch prints inside the body
                # still go through slots / loud refusals as usual.
                sub.printed = []
                unpack(sub, carry)
                ret = self._exec_block(stmt.stmt, sub)
                if ret is not None:
                    raise CLiftError(
                        f"return inside a loop at {stmt.coord}; restructure")
                if stmt.next is not None:
                    self.eval(stmt.next, sub)
                self._guard_reseat(sc, sub, stmt.coord)
                return (tuple(sub.read_binding(n) for n in carry_names),
                        tuple(cnp.asarray(p) for p in sub.printed))

            out, ys = loops.scan(self._replayable(body), pack(), None,
                                 length=trip)
            unpack(sc, out)
            if ys:
                if (isinstance(sc.printed, _NoPrintList)
                        and "__print_buf" in sc.g
                        and all(cnp.ndim(y) == 1 for y in ys)):
                    # Stacked prints inside a DYNAMIC outer context flow
                    # into the UART buffer in true stdout order
                    # (iteration-major interleave).
                    flat = cnp.stack(
                        [y.astype(cnp.uint32) for y in ys],
                        axis=1).reshape(-1)
                    buf = sc.g["__print_buf"]
                    cnt = sc.g["__print_cnt"]
                    idx = cnt + cnp.arange(flat.size, dtype=cnp.int32)
                    # mode="drop" discards out-of-range writes outright:
                    # clipping them onto the last word would scatter
                    # duplicate indices with conflicting values, and JAX
                    # leaves duplicate-index order unspecified -- the
                    # legit final word could lose to a stale overflow row
                    # exactly when the buffer fills.
                    buf = buf.at[idx].set(flat, mode="drop")
                    sc.g["__print_buf"] = buf
                    sc.g["__print_cnt"] = cnt + flat.size
                else:
                    sc.printed.extend(list(ys))
            return None

        # A side-effecting condition (C's `while (length--)`) cannot be
        # evaluated in the while cond function -- writes made there are
        # discarded.  Rotate the loop instead: evaluate the condition once
        # up front (its effects apply), carry its truth value, and have
        # each iteration run body+next then re-evaluate the condition with
        # effects inside the body.  Exact C semantics, including the final
        # value of the side-effected variable after the failing test.
        if stmt.cond is not None and self._loop_carry(stmt.cond, sc):
            # int32 truth carry, not bool: every loop carry can become an
            # injectable region leaf, and the memory map is 32-bit words.
            t0 = self._truth(self.eval(stmt.cond, sc)).astype(cnp.int32)

            def cond_rot(carry):
                return cnp.not_equal(carry[-1], 0)

            def body_rot(carry):
                sub = sc.fork(no_print_at=stmt.coord)
                unpack(sub, carry[:-1])
                ret = self._exec_block(stmt.stmt, sub)
                if ret is not None:
                    raise CLiftError(
                        f"return inside a loop at {stmt.coord}; "
                        "restructure")
                if stmt.next is not None:
                    self.eval(stmt.next, sub)
                t = self._truth(self.eval(stmt.cond, sub)
                                ).astype(cnp.int32)
                self._guard_reseat(sc, sub, stmt.coord)
                return tuple(sub.read_binding(n) for n in carry_names) + (t,)

            out = loops.while_loop(self._replayable(cond_rot),
                                   self._replayable(body_rot),
                                   pack() + (t0,))
            unpack(sc, out[:-1])
            return None

        # General for: lower as while with explicit cond/next.
        def cond_f(carry):
            sub = sc.fork(no_print_at=stmt.coord)
            unpack(sub, carry)
            c = (self.eval(stmt.cond, sub) if stmt.cond is not None
                 else cnp.int32(1))
            return self._truth(c)

        def body_f(carry):
            sub = sc.fork(no_print_at=stmt.coord)
            unpack(sub, carry)
            ret = self._exec_block(stmt.stmt, sub)
            if ret is not None:
                raise CLiftError(
                    f"return inside a loop at {stmt.coord}; restructure")
            if stmt.next is not None:
                self.eval(stmt.next, sub)
            self._guard_reseat(sc, sub, stmt.coord)
            return tuple(sub.read_binding(n) for n in carry_names)

        out = loops.while_loop(self._replayable(cond_f),
                               self._replayable(body_f), pack())
        unpack(sc, out)
        return None

    def _count_breaks(self, node) -> int:
        count = 0

        class V(c_ast.NodeVisitor):
            def visit_Break(v, n):
                nonlocal count
                count += 1

            def visit_While(v, n):      # breaks inside nested loops bind
                pass                    # to THOSE loops; don't descend

            def visit_For(v, n):
                pass

        V().visit(node)
        return count

    def _exec_while(self, stmt, sc: _Scope):
        # The run-once idiom ``while (1) { ...; break; }`` (sha256.c's
        # main): a body whose LAST top-level statement is the loop's only
        # break executes exactly once under the condition -- and with a
        # static-true condition it inlines into the enclosing scope, so
        # printf stays a program output.
        items = (stmt.stmt.block_items or []
                 if isinstance(stmt.stmt, c_ast.Compound) else [stmt.stmt])
        if items and isinstance(items[-1], c_ast.Break):
            body = c_ast.Compound(list(items[:-1]), stmt.stmt.coord)
            if self._count_breaks(body):
                raise CLiftError(
                    f"break before the tail of the loop at {stmt.coord}; "
                    "restructure")
            if _const_int(stmt.cond):
                return self._exec_block(body, sc)
            return self._exec_stmt(
                c_ast.If(stmt.cond, body, None, stmt.coord), sc)
        fake = c_ast.For(None, stmt.cond, None, stmt.stmt, stmt.coord)
        return self._exec_for(fake, sc)

    def _static_trip(self, stmt, sc) -> Optional[int]:
        """Trip count for the canonical `for (i = A; i < B; i++)` shape
        with literal A/B and the loop variable not written in the body."""
        init, cond, nxt = stmt.init, stmt.cond, stmt.next
        if init is None or cond is None or nxt is None:
            return None
        # init: i = A (assignment or single decl)
        if isinstance(init, c_ast.DeclList) and len(init.decls) == 1:
            var, a = init.decls[0].name, _const_int(init.decls[0].init)
        elif isinstance(init, c_ast.Assignment) and init.op == "=" \
                and isinstance(init.lvalue, c_ast.ID):
            var, a = init.lvalue.name, _const_int(init.rvalue)
        else:
            return None
        if a is None:
            return None
        if not (isinstance(cond, c_ast.BinaryOp) and cond.op in ("<", "<=")
                and isinstance(cond.left, c_ast.ID)
                and cond.left.name == var):
            return None
        b = _const_int(cond.right)
        if b is None:
            return None
        inc_ok = (isinstance(nxt, c_ast.UnaryOp)
                  and nxt.op in ("++", "p++")
                  and isinstance(nxt.expr, c_ast.ID)
                  and nxt.expr.name == var)
        if not inc_ok:
            return None
        # The loop variable must not be written inside the body (the scan
        # carries it via the next-expression only).
        if var in self._assigned_names(stmt.stmt):
            return None
        trip = (b - a) + (1 if cond.op == "<=" else 0)
        return max(0, trip)

    def _exec_if(self, stmt, sc: _Scope):
        self._preseat(stmt, sc)
        if not self._has_effects(stmt.cond):
            kc = self._const_eval(stmt.cond, sc)
            if kc is not None:
                # Statically-decided predicate: execute only the taken
                # branch INLINE (exact C semantics; keeps trace-time
                # constants known -- aes_enc.c's switch on a literal
                # `type` must yield a known nb for the ciphertext print
                # loop -- and keeps prints in statically-taken branches
                # legal program outputs).
                node = stmt.iftrue if kc else stmt.iffalse
                return (self._exec_block(node, sc)
                        if node is not None else None)
        cval = self.eval(stmt.cond, sc)      # cond effects apply once
        carry_names = self._loop_carry(stmt, sc)
        c = self._truth(cval)

        def branch(node):
            def run(vals):
                sub = sc.fork(
                    no_print_at=stmt.coord,
                    no_print_reason=self._synth_reason.get(id(stmt)))
                for n, v in zip(carry_names, vals):
                    sub.write_binding(n, v)
                if node is not None:
                    ret = self._exec_block(node, sub)
                    if ret is not None:
                        raise CLiftError(
                            f"return inside if at {stmt.coord}; restructure")
                self._guard_reseat(sc, sub, stmt.coord)
                return tuple(sub.read_binding(n) for n in carry_names)
            return run

        vals = tuple(sc.read_binding(n) for n in carry_names)
        out = _select(c, branch(stmt.iftrue)(vals),
                      branch(stmt.iffalse)(vals))
        for n, v in zip(carry_names, out):
            sc.write_binding(n, v)
            sc.consts.pop(n, None)           # traced write: value unknown
        return None


# ---------------------------------------------------------------------------
# Translation-unit ingestion
# ---------------------------------------------------------------------------



def _select(c, a: tuple, b: tuple) -> tuple:
    """``lax.cond(c, ...)`` of the two branches' carries, as the
    reference's cond runs under ``vmap``: both branches ran, and each
    value is ``a`` where ``c`` holds, else ``b``.  A value both branches
    hand back unchanged stays that value (the cond's passthrough).  The
    predicate is tagged a branch predicate for the step's dataflow, as
    the reference's walk reads a ``cond``."""
    pred = cnp.asarray(c).t
    loops.count_eqns(1)                      # the reference's cond
    loops.mark(pred, "coast:branch_pred")
    out = []
    for va, vb in zip(a, b):
        la, ta = loops.flatten(va)
        lb, _ = loops.flatten(vb)
        if len(la) != len(lb):
            raise CLiftError("the branches of an if leave a value in two "
                             "shapes (a 64-bit value on one side only)")
        out.append(loops.unflatten(ta, [
            x if x is y else loops.select_rows(pred, x, y)
            for x, y in zip(la, lb)]))
    return tuple(out)
