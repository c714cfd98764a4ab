"""The timed path broken underneath on purpose, for the tests that show the
correctness check catches it: subclasses of the benchmark's engine class,
handed to ``run_cell`` in its place. Never used by a benchmark run.

* ``"token"``: every token a prefill or a decode produces is replaced by
  the next id;
* ``"half_prompt"``: each prefill sees only the second half of its prompt;
* ``"stale_state"``: the decode step writes its K/V rows into a copy, so
  the cache it returns is the one it was given;
* ``"half_batch"``: only the first half of the active slots (rounded down)
  is decoded, the others repeat their last token;
* ``"page_rows"``: (paged engine) the rows a page gather returns have their
  last page zeroed.
"""

from portbench.harness.engine import bench_engine_class

FAULTS = ("token", "half_prompt", "stale_state", "half_batch", "page_rows")


def faulty_engine_class(fault: str):
    """A replacement for ``bench_engine_class`` whose engines carry ``fault``."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")

    def make(base):
        class FaultyEngine(bench_engine_class(base)):
            def _wrap_pages(self, kv):
                super()._wrap_pages(kv)
                if fault == "page_rows":
                    gather = kv.gather

                    def zeroed(rid):
                        n = kv.length(rid)
                        out = gather(rid)
                        _zero_last_page(out, n, kv.page_size)
                        return out

                    kv.gather = zeroed

            def _prefill_request(self, req):
                out = super()._prefill_request(req)
                if fault == "token":
                    req.out_tokens[-1] = (req.out_tokens[-1] + 1) % self.cfg.vocab
                return out

            def _prefill(self, params, batch):
                if fault == "half_prompt":
                    tokens = batch["tokens"]
                    batch = {**batch, "tokens": tokens[:, tokens.shape[1] // 2:]}
                return super()._prefill(params, batch)

            def _decode(self, params, cache, tokens, pos):
                if fault == "stale_state":
                    shadow = [[tuple(t.clone() for t in pair) for pair in group] for group in cache]
                    logits, _ = super()._decode(params, shadow, tokens, pos)
                    return logits, cache
                return super()._decode(params, cache, tokens, pos)

            def _decode_active(self):
                active, nxt = super()._decode_active()
                if active and fault == "token":
                    nxt = (nxt + 1) % self.cfg.vocab
                elif active and fault == "half_batch":
                    nxt = nxt.copy()
                    for i in active[len(active) // 2:]:  # the larger half of an odd batch
                        nxt[i] = self.cur_tok[i]
                return active, nxt

        return FaultyEngine

    return make


def _zero_last_page(cache, length: int, page_size: int) -> None:
    """Zero positions ``[last page start, length)`` of every leaf of a B=1
    cache."""
    a = max(0, (length - 1) // page_size * page_size)
    for group in cache:
        for pair in group:
            for t in pair:
                t[:, :, a:length].zero_()
