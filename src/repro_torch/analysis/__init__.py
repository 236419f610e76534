"""Performance analysis over the port's telemetry: roofline terms, the
stage-attribution report and the benchmark regression tracker."""
