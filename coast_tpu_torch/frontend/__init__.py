"""Frontend: automatic region lifting.

The counterpart of ``coast_tpu/frontend``.  The reference's engine
protects arbitrary programs: ``opt`` discovers what to clone from the
module itself (populateValuesToClone, cloning.cpp:62-288) and the user
only annotates scope.  ``lift_step`` takes a stepped function over a state
dict, ``lift_fn`` a whole function whose main loops are written with
``frontend.loops.scan`` / ``loops.while_loop``, and ``lift_c`` a
restricted-C program (``c_lifter``); each derives the protected Region:
state discovery, leaf kinds from the step's captured dataflow,
termination, a golden self-check and a block graph.
"""

from coast_tpu_torch.frontend.lifter import LiftError, lift_fn, lift_step


def lift_c(*args, **kwargs):
    """Restricted-C ingestion (``frontend.c_lifter.lift_c``); imported
    lazily so the pycparser dependency stays off the default import
    path."""
    from coast_tpu_torch.frontend.c_lifter import lift_c as _lift_c
    return _lift_c(*args, **kwargs)


__all__ = ["lift_step", "lift_fn", "lift_c", "LiftError"]
