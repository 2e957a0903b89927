"""Share of the replay's gap lookups that the host engine served, in %:
``stats["host_fallback"]`` over prefetch hits, misses and host fallbacks."""


def read(m):
    s = m.stats
    lookups = s["prefetch_hit"] + s["prefetch_miss"] + s["host_fallback"]
    return 100.0 * s["host_fallback"] / lookups if lookups else None
