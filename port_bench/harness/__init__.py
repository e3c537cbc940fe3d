"""The port benchmark's harness: inputs, loops, trace reduction, yardsticks."""
