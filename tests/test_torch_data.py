"""The port's token stream (a numpy-only copy of the JAX package's)
draws the same batches, bit for bit: over several steps, for one host
and for a host's shard of two, and after ``state()`` / ``restore()``."""
import _torch_threads  # noqa: F401  (first: see the module)

import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import TokenStream as JTokenStream
from repro_torch.data import DataConfig, TokenStream


@pytest.mark.parametrize("hosts,host", [(1, 0), (2, 1)])
def test_batches_equal_jax(hosts, host):
    kw = dict(vocab_size=5000, seq_len=24, global_batch=4, seed=3,
              n_hosts=hosts, host_id=host)
    j, t = JTokenStream(JDataConfig(**kw)), TokenStream(DataConfig(**kw))
    for _ in range(4):
        a, b = j.next_batch(), t.next_batch()
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert b[k].dtype == a[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], a[k])
    assert b["tokens"].shape == (4 // hosts, 24)
    assert (b["labels"][:, -1] == -1).all()


def test_state_and_restore():
    kw = dict(vocab_size=300, seq_len=16, global_batch=2)
    j, t = JTokenStream(JDataConfig(**kw)), TokenStream(DataConfig(**kw))
    for _ in range(3):
        j.next_batch(), t.next_batch()
    assert t.state() == j.state() == {"step": 3}
    again = TokenStream(DataConfig(**kw))
    again.restore(t.state())
    jagain = JTokenStream(JDataConfig(**kw))
    jagain.restore(j.state())
    for _ in range(2):
        want = jagain.next_batch()
        for got in (again.next_batch(), t.next_batch()):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
