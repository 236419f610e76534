"""The harness: the spec, the window loop, the trace reader, the roofline
count, the data generators and the plain reference."""
