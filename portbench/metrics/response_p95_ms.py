"""95th percentile of the response times of all requests the window
served, in ms: from the host clock before ``submit`` to the host clock
after the synchronize that closed the ``step()`` that served it.  Linear
interpolation between order statistics."""

import numpy as np


def p95_ms(requests):
    times = [r.finish - r.submit for r in requests if not r.failed]
    if not times:
        return None
    return 1e3 * float(np.percentile(np.asarray(times), 95.0))


def read(obs):
    return p95_ms(obs.requests)
