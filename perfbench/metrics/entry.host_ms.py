"""entry.host_ms: the traced run's median pricing wall through the entry,
less the sum of its layers' median spans (each a host clock around the
layer's public function, ended by a synchronise), in ms. Nothing to read
where a layer has no public function of its own, since that layer's time is
then the entry's remainder."""


def read(ctx: dict):
    host = ctx.get("entry_host_s")
    return None if host is None else 1e3 * host
