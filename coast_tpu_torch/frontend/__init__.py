"""Frontend: automatic region lifting.

The counterpart of ``coast_tpu/frontend``.  The reference's engine
protects arbitrary programs: ``opt`` discovers what to clone from the
module itself (populateValuesToClone, cloning.cpp:62-288) and the user
only annotates scope.  ``lift_step`` takes a stepped function over a state
dict, ``lift_fn`` a whole function whose main loops are written with
``frontend.loops.scan`` / ``loops.while_loop``, and each derives the
protected Region: state discovery, leaf kinds from the step's captured
dataflow, termination, a golden self-check and a block graph.
"""

from coast_tpu_torch.frontend.lifter import LiftError, lift_fn, lift_step


def lift_c(source="<source>", *args, **kwargs):
    """Restricted-C ingestion is not ported yet: the refusal
    ``models.resolve_region`` gives a ``.c`` program (ROADMAP item 17d)."""
    raise NotImplementedError(
        f"{source}: C-source programs need the restricted-C lifter, "
        "ROADMAP Queue A item 17d")


__all__ = ["lift_step", "lift_fn", "lift_c", "LiftError"]
