"""The benchmark's general code: the manifest, inputs, weights, the trace reader
and the comparison that decides `correct`."""
