"""Route adapters: one module per (product kind, engine), named
``<product kind>_<engine>``. Each defines ``Route(config, device)`` with
``price(seed)`` (the timed entry; its values on the host), ``layers(seed)``
(``{layer: seconds}`` of the same pricing through each layer that runs in a
public function of the program), ``judge(seed, outputs)`` (the numbers that
decide ``correct``, from the plain reference of that pricing) and
``control(seed)`` (the reference computed in bfloat16, in the program's
output form); and ``REST``, the layer whose time is the entry's less the
others' spans where no public function runs it alone (else ``None``)."""
