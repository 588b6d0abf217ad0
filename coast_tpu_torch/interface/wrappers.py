"""Signature-rewrite features as function transforms over replica sets.

The counterpart of ``coast_tpu/interface/wrappers.py``.  The reference
rewrites function signatures in IR (cloned arguments, ``.RR`` out-pointer
returns, ``_COAST_WRAPPER`` renames); here the same call-boundary
contracts are transforms over torch callables.  Every tensor carries the
port's leading row axis ``R``; a replica set is ``[R, n, ...]`` (the lane
axis is :data:`LANE_AXIS`).

Boundary transforms, explicit lane axis:

  protected_lib      -- replicated body behind a single-copy signature:
                        the arguments are copied into ``n`` lanes, the
                        body runs once a lane and its result is voted,
                        one K1 launch for every result leaf; returns
                        ``(voted, miscompare bool [R])``.
  replicated_return  -- the ``.RR`` form: per-lane arguments in, per-lane
                        results out, no boundary sync.
  clone_after_call   -- call once on single-copy arguments, then give
                        every lane its own copy of the result.
  no_xmr_arg         -- ``replicated_return`` with some argument positions
                        single-copy (shared across lanes).

In-lane forms, the engine's function-scope classes: the engine runs the
region's step on ``[B * n]`` rows (campaign row major, lane minor), and a
wrapper regroups its arguments to ``[B, n, ...]``.  The votes of one call
site are one grouped K1 launch (``ops/hopper_voters.vote_sites``; its
plain version for a CPU tensor), and each voted leaf appends one row to
the namespace's miscompare log (``FnNamespace.miscompares``, int32
``[S, B]`` blocks), which the engine latches: a DWC abort or a TMR
correction per miscompared leaf, one sync per leaf.  A Python number
argument is a leaf too: the reference votes it as a constant array, so
it is voted here as a constant replica set in the same launch (it always
agrees, and counts as a sync).

  lane_ignored          -- -ignoreFns: arguments voted, the body runs once
                           on the voted copies, the result re-enters every
                           lane.
  lane_skip_lib         -- -skipLibCalls: one call on lane 0's arguments,
                           no sync; a fault in lane 0's arguments reaches
                           every lane (the accepted single point of
                           failure).
  lane_protected_lib    -- -protectedLibFn: arguments voted in, the body
                           runs per lane, its result voted out.
  lane_clone_after_call -- -cloneAfterCall: one call on lane 0's
                           arguments, the result fanned out to every lane.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from coast_tpu_torch.ops import hopper_voters, site_table, voters
from coast_tpu_torch.ops.voters import Site

#: The lane axis of a replica set ``[R, n, ...]``.
LANE_AXIS = 1


# -- small pytree helpers (a tensor, or a tuple/list of them) ---------------

def _flatten(out) -> Tuple[List[torch.Tensor], Callable]:
    if isinstance(out, (tuple, list)):
        kind = type(out)
        return list(out), lambda leaves: kind(leaves)
    return [out], lambda leaves: leaves[0]


def _vote(sets: Sequence[torch.Tensor], num_clones: int
          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Vote replica sets ``[R, n, ...]`` in grouped K1 launches of at most
    ``MAX_SITES`` sites -> ``(voted per set, flags int32 [S, R])``."""
    voted, flags = [], []
    for i in range(0, len(sets), site_table.MAX_SITES):
        v, f = hopper_voters.vote_sites(
            [Site(x) for x in sets[i:i + site_table.MAX_SITES]], num_clones)
        voted += v
        flags.append(f)
    return voted, flags[0] if len(flags) == 1 else torch.cat(flags)


def _fan_out(x: torch.Tensor, num_clones: int) -> torch.Tensor:
    """``[R, ...]`` -> every lane its own copy, ``[R, n, ...]``."""
    return x.unsqueeze(LANE_AXIS).expand(
        x.shape[0], num_clones, *x.shape[1:]).contiguous()


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[R, n, ...]`` -> the lanes as rows, ``[R * n, ...]``."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _lanes(x: torch.Tensor, num_clones: int) -> torch.Tensor:
    """``[R * n, ...]`` rows -> the replica set ``[R, n, ...]``."""
    return x.reshape(-1, num_clones, *x.shape[1:]).contiguous()


def _name(fn: Callable, name) -> str:
    return name or getattr(fn, "__name__", "fn")


# -- boundary transforms -----------------------------------------------------

def protected_lib(fn: Callable, num_clones: int = 3,
                  static_argnums: Sequence[int] = ()) -> Callable:
    """Wrap ``fn(*args)``: single-copy signature, replicated body, voted
    result.  Tensor arguments ``[R, ...]`` are copied into ``n`` lanes so
    every lane computes from its own copy; ``static_argnums`` positions
    pass through unreplicated.  Returns ``(voted, miscompare bool [R])``."""
    if num_clones < 2:
        raise ValueError("protected_lib needs num_clones >= 2")
    static = frozenset(static_argnums)

    def wrapper(*args):
        lane_args = [a if i in static else _rows(_fan_out(a, num_clones))
                     for i, a in enumerate(args)]
        flat, rebuild = _flatten(fn(*lane_args))
        voted, flags = _vote([_lanes(x, num_clones) for x in flat],
                             num_clones)
        return rebuild(voted), flags.any(dim=0)

    wrapper.__name__ = f"{_name(fn, None)}_COAST_WRAPPER"
    return wrapper


def replicated_return(fn: Callable, num_clones: int = 3,
                      no_xmr_args: Sequence[int] = ()) -> Callable:
    """Wrap ``fn`` as its ``.RR`` form: arguments carry the lane axis
    (``[R, n, ...]``) except positions in ``no_xmr_args`` (``[R, ...]``,
    shared), and the result is per lane with no sync."""

    def wrapper(*args):
        rows = []
        for i, a in enumerate(args):
            if i in no_xmr_args:
                rows.append(_rows(_fan_out(a, num_clones)))
                continue
            if a.dim() < 2 or a.shape[LANE_AXIS] != num_clones:
                raise ValueError(
                    f"{wrapper.__name__}: argument {i} has shape "
                    f"{tuple(a.shape)} without a lane axis of {num_clones} "
                    "replicas")
            rows.append(_rows(a))
        flat, rebuild = _flatten(fn(*rows))
        return rebuild([_lanes(x, num_clones) for x in flat])

    wrapper.__name__ = f"{_name(fn, None)}.RR"
    return wrapper


def no_xmr_arg(*argnums: int):
    """``replicated_return(fn, n, no_xmr_args=argnums)`` as an annotation,
    the shape of the __NO_xMR_ARG(n) macro."""
    def apply(fn: Callable, num_clones: int = 3) -> Callable:
        return replicated_return(fn, num_clones, no_xmr_args=argnums)
    return apply


def clone_after_call(fn: Callable, num_clones: int = 3) -> Callable:
    """Wrap ``fn``: call once on single-copy arguments, give every lane its
    own (initially identical, independently corruptible) result."""

    def wrapper(*args):
        flat, rebuild = _flatten(fn(*args))
        return rebuild([_fan_out(x, num_clones) for x in flat])

    wrapper.__name__ = f"{_name(fn, None)}_CLONE_AFTER_CALL_1_2"
    return wrapper


# -- in-lane forms (the engine's function-scope classes) ---------------------

def _arg_sets(args, num_clones: int, env) -> List[torch.Tensor]:
    """Each argument as a replica set ``[B, n, ...]``: a row tensor
    regrouped, a Python number as a constant set of ``env.batch`` rows on
    ``env.device``."""
    sets = []
    for a in args:
        if isinstance(a, torch.Tensor):
            sets.append(_lanes(a, num_clones))
        else:
            dtype = torch.float32 if isinstance(a, float) else torch.int32
            sets.append(torch.full((env.batch, num_clones), a, dtype=dtype,
                                   device=env.device))
    return sets


def _vote_in(args, num_clones: int, env, fn_name: str
             ) -> List[torch.Tensor]:
    """The call-boundary vote of every argument (one launch), logged;
    each set tagged a ``call_boundary`` sync of ``fn_name``."""
    voted, flags = _vote([voters.sync_tag(x, "call_boundary", fn_name)
                          for x in _arg_sets(args, num_clones, env)],
                         num_clones)
    env.miscompares.append(flags)
    return voted


def _lane0(args, num_clones: int, fn_name: str) -> list:
    """Lane 0's arguments, ``[B, ...]``; Python numbers as they are.  The
    read is tagged ``coast:spof:<fn>``: the linter's SPOF report matches
    it against the skipLibCalls/cloneAfterCall allowlist."""
    return [voters.tag(a.reshape(-1, num_clones, *a.shape[1:]),
                       voters.TAG_SPOF + fn_name)[:, 0]
            if isinstance(a, torch.Tensor) else a for a in args]


def _enter_lanes(out, num_clones: int):
    """A single result ``[B, ...]`` into every lane: ``[B * n, ...]``."""
    flat, rebuild = _flatten(out)
    return rebuild([_rows(_fan_out(x, num_clones)) for x in flat])


def lane_ignored(fn: Callable, num_clones: int, env,
                 name: str = None) -> Callable:
    """-ignoreFns: the function is outside the sphere of replication.
    Every crossing argument is voted, the body runs once on the voted
    copies, and its result re-enters every lane."""
    fname = _name(fn, name)

    def wrapper(*args):
        voted = _vote_in(args, num_clones, env, fname)
        return _enter_lanes(fn(*voted), num_clones)

    wrapper.__name__ = f"{fname}_IGNORED"
    return wrapper


def lane_skip_lib(fn: Callable, num_clones: int,
                  name: str = None) -> Callable:
    """-skipLibCalls: one call on lane 0's arguments, no sync."""
    fname = _name(fn, name)

    def wrapper(*args):
        return _enter_lanes(fn(*_lane0(args, num_clones, fname)), num_clones)

    wrapper.__name__ = f"{fname}_SKIPLIB"
    return wrapper


def lane_protected_lib(fn: Callable, num_clones: int, env,
                       name: str = None) -> Callable:
    """-protectedLibFn: replicated body behind a single-copy signature.
    Arguments are voted in, the body runs per lane on the voted copies,
    and its result is voted out: two logged call-boundary votes."""
    fname = _name(fn, name)

    def wrapper(*args):
        voted_in = _vote_in(args, num_clones, env, fname)
        lane_args = [_rows(_fan_out(x, num_clones)) for x in voted_in]
        flat, rebuild = _flatten(fn(*lane_args))
        voted_out = _vote_in(flat, num_clones, env, fname)
        return _enter_lanes(rebuild(voted_out), num_clones)

    wrapper.__name__ = f"{fname}_COAST_WRAPPER"
    return wrapper


def lane_clone_after_call(fn: Callable, num_clones: int,
                          name: str = None) -> Callable:
    """-cloneAfterCall: one call on lane 0's (single-copy) arguments, the
    result fanned out: every lane gets its own copy, which then lives and
    corrupts on its own."""
    fname = _name(fn, name)

    def wrapper(*args):
        return _enter_lanes(fn(*_lane0(args, num_clones, fname)), num_clones)

    wrapper.__name__ = f"{fname}_CLONE_AFTER_CALL_1_2"
    return wrapper
