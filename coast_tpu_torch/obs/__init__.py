"""Observability of the port: statistical convergence (Wilson intervals,
early stop).  The span recorder, trace export and live metrics are ROADMAP
Queue A item 18."""
