"""Telemetry (the port of ``repro.obs``): so far the host collectors of
``obs.metrics``; the device rings, the tracer and ``ObsRun`` are ROADMAP
A.14."""
