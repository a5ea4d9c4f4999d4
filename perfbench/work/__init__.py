"""Work counts: one module per route, ``work(config)`` giving each layer's
bytes (each input read once, each output written once) and float32 and
float64 operations, counted from the configuration's shapes."""
