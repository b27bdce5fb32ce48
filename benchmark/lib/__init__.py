"""The harness's own code: inputs, timing, the trace's reduction, the yardsticks."""
