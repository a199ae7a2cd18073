"""The traffic generator: deterministic in the seed, the stated lengths."""

import numpy as np

from portbench.harness import kbgen, reference, traffic

SERVE = {"sentences": 1024, "batch": 32, "block": 256, "len_median": 12,
         "len_sigma": 0.5, "len_min": 4, "len_max": 40}


def topics():
    _, _, tm = kbgen.synth_wiki_docs(2000, n_topics=40, seed=0)
    return tm


def test_backlog_is_deterministic_in_the_seed():
    tm = topics()
    a = traffic.backlog(SERVE, 2**31 + 17, tm)
    b = traffic.backlog(SERVE, 2**31 + 17, tm)
    c = traffic.backlog(SERVE, 5, tm)
    assert a == b
    assert a != c


def test_backlog_lengths_follow_the_stated_distribution():
    tm = topics()
    for seed in (1, 2, 3):
        lens = np.array([len(r["tokens"])
                         for r in traffic.backlog(SERVE, seed, tm)])
        assert lens.min() >= 4 and lens.max() <= 40
        assert np.median(lens) == 12
        # every block of 256 holds the same lengths, in another order
        blocks = lens.reshape(-1, 256)
        assert all((np.sort(b) == np.sort(blocks[0])).all() for b in blocks)
    a = [len(r["tokens"]) for r in traffic.backlog(SERVE, 1, tm)]
    b = [len(r["tokens"]) for r in traffic.backlog(SERVE, 2, tm)]
    assert a != b and sorted(a) == sorted(b)


def test_sentences_draw_topic_entities_at_the_kb_share():
    tm = topics()
    rng = np.random.RandomState(0)
    _, flags, _ = traffic.sentences(dict(SERVE, block=64), 4096, rng, tm)
    share = np.mean([f for fl in flags for f in fl])
    assert abs(share - tm.entity_frac) < 0.02


def test_fused_records_fill_the_budget():
    tm = topics()
    p = dict(SERVE, records=64, block=16, budget=510,
             context={"len_mean": 22, "len_sigma": 0.45, "len_min": 4,
                      "len_max": 64})
    recs = traffic.fused_records(p, 7, tm)
    assert recs == traffic.fused_records(p, 7, tm)
    for tokens, tags in recs:
        n = tokens.index(reference.EOS)
        assert len(tokens) == len(tags)
        assert set(tags[n:]) == {"S-X"}
        assert set(tags[:n]) <= set(traffic.tag_list())
        used = reference.subtokens(tokens[:n] + tokens[n + 1:]) + 1
        assert 510 - 140 < used <= 510  # the next context (<= 136) did not fit


def test_bioes_marks_each_entity_run():
    assert traffic.bioes([True, False, True, True, True, False], "PER") == [
        "S-PER", "O", "B-PER", "I-PER", "E-PER", "O"]
