"""The slice as a whole on the CPU: MXNet's word-level LSTM language model
(`example/gluon/word_language_model`: embedding, a 2-layer LSTM, a
decoder tied to the embedding's weight) over the synthetic WikiText-2
stand-in, trained by the imperative loop (`autograd.record` ->
`backward` -> `gluon.utils.clip_global_norm` -> `Trainer("sgd").step`)
with the hidden state carried and detached between batches, at width 32
and dropout 0, against the same loop in the JAX package.

The corpus's token ids and the `Vocabulary` are bit-equal to JAX's (both
come from numpy); three steps' losses agree at rtol 1e-5 and the weights
after them at rtol 1e-4 (atol 1e-5). Also `contrib.text` (token counts,
`Vocabulary`, `TokenEmbedding` from a local file), the contrib
`IntervalSampler` and the contrib layers (`Concurrent`,
`HybridConcurrent`, `Identity`, `SyncBatchNorm`, `PixelShuffle{1,2,3}D`,
values at rtol 1e-5, atol 1e-6, gradients at rtol 1e-4, atol 1e-5)
against JAX's.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.contrib import text as jtext
from incubator_mxnet_tpu.gluon.contrib import data as jdata
from incubator_mxnet_tpu_torch.contrib import text as ttext
from incubator_mxnet_tpu_torch.gluon.contrib import data as tdata
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params
from test_torch_imperative import _jax_block, _port_block

CPU = tmx.cpu()
WIDTH, LAYERS, BPTT, BATCH, STEPS = 32, 2, 5, 4, 3
LR, CLIP = 20.0, 0.2


# -- corpus and vocabulary -------------------------------------------------

@pytest.mark.parametrize("cls", ["WikiText2", "WikiText103"])
def test_synthetic_corpus_and_vocabulary_are_bit_equal(cls):
    j = getattr(jdata, cls)(segment="train", seq_len=35)
    t = getattr(tdata, cls)(segment="train", seq_len=35)
    assert j.vocab.idx_to_token == t.vocab.idx_to_token
    np.testing.assert_array_equal(t._data, j._data)
    np.testing.assert_array_equal(t._label, j._label)
    jv = getattr(jdata, cls)(segment="val", vocab=j.vocab, seq_len=35)
    tv = getattr(tdata, cls)(segment="val", vocab=t.vocab, seq_len=35)
    np.testing.assert_array_equal(tv._data, jv._data)
    assert len(tv) == len(jv)
    x, y = tv[3]
    np.testing.assert_array_equal(x, jv[3][0])
    np.testing.assert_array_equal(y, jv[3][1])


def test_local_root_is_read_and_a_missing_file_raises(tmp_path):
    (tmp_path / "wiki.train.tokens").write_text(
        "the cat sat\n on the mat\nthe end\n")
    for pkg in (jdata, tdata):
        ds = pkg.WikiText2(root=str(tmp_path), seq_len=2)
        assert ds.vocab.idx_to_token[:4] == ["<unk>", "<eos>", "the", "cat"]
    np.testing.assert_array_equal(
        tdata.WikiText2(root=str(tmp_path), seq_len=2)._data,
        jdata.WikiText2(root=str(tmp_path), seq_len=2)._data)
    with pytest.raises(FileNotFoundError, match="wiki.valid.tokens"):
        tdata.WikiText2(root=str(tmp_path), segment="val")


def test_interval_sampler_matches_jax():
    for args in ((13, 3), (10, 4, False), (5, 5)):
        assert list(tdata.IntervalSampler(*args)) == \
            list(jdata.IntervalSampler(*args))
        assert len(tdata.IntervalSampler(*args)) == \
            len(jdata.IntervalSampler(*args))


def test_text_vocabulary_and_embedding_match_jax(tmp_path):
    src = "a b b c c c d\nd d d e  f\n\nA B"
    for kw in ({}, {"to_lower": True}):
        assert ttext.count_tokens_from_str(src, **kw) == \
            jtext.count_tokens_from_str(src, **kw)
    counter = jtext.count_tokens_from_str(src)
    for kw in ({}, {"most_freq_count": 3}, {"min_freq": 2},
               {"reserved_tokens": ["<pad>", "<bos>"]}):
        jv, tv = jtext.Vocabulary(counter, **kw), ttext.Vocabulary(counter,
                                                                  **kw)
        assert tv.idx_to_token == jv.idx_to_token
        assert tv.to_indices(["d", "zzz", "c"]) == \
            jv.to_indices(["d", "zzz", "c"])
        assert tv.to_tokens([0, 1]) == jv.to_tokens([0, 1])
    path = tmp_path / "vec.txt"
    path.write_text("b 1 2 3 4\nc 0.5 0.5 0.5 0.5\nz 9 9 9 9\n")
    vocab = jtext.Vocabulary(counter)
    je = jtext.TokenEmbedding(str(path), vocabulary=vocab)
    with tmx.cpu():
        te = ttext.TokenEmbedding(str(path), vocabulary=ttext.Vocabulary(
            counter))
        np.testing.assert_array_equal(te.idx_to_vec.asnumpy(),
                                      je.idx_to_vec.asnumpy())
        np.testing.assert_array_equal(
            te.get_vecs_by_tokens(["c", "B", "q"],
                                  lower_case_backup=True).asnumpy(),
            je.get_vecs_by_tokens(["c", "B", "q"],
                                  lower_case_backup=True).asnumpy())
        te.update_token_vectors("d", np.ones(4))
        je.update_token_vectors("d", np.ones(4))
        assert te.idx_to_vec.context == CPU
        np.testing.assert_array_equal(te.idx_to_vec.asnumpy(),
                                      je.idx_to_vec.asnumpy())


# -- the language model ------------------------------------------------------

def rnn_model(mx, vocab_size, width, layers, dropout):
    """The reference word LM's RNNModel, tied decoder."""
    nn, rnn = mx.gluon.nn, mx.gluon.rnn

    class RNNModel(mx.gluon.Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(vocab_size, width)
                self.rnn = rnn.LSTM(width, layers, dropout=dropout,
                                    input_size=width)
                self.decoder = nn.Dense(vocab_size, in_units=width,
                                        params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            decoded = self.decoder(output.reshape((-1, width)))
            return decoded, hidden

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel()


def batchify(ids, batch):
    n = len(ids) // batch
    return ids[:n * batch].reshape(batch, n).T  # (T, B)


def _corpus():
    ds = jdata.WikiText2(segment="train", seq_len=35)
    return batchify(ds._data.reshape(-1), BATCH), len(ds.vocab)


def _weights(net, seed=0):
    rng = np.random.RandomState(seed)
    return {n: (rng.uniform(-0.1, 0.1, p.shape)).astype(np.float32)
            for n, p in net.collect_params().items()}


def _train(mx, net, source, ctx):
    """STEPS steps of the reference loop; returns the losses (the batch
    mean of each step, as float)."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": LR})
    hidden = net.begin_state(func=mx.nd.zeros, batch_size=BATCH, ctx=ctx)
    losses = []
    for i in range(0, STEPS * BPTT, BPTT):
        data = mx.nd.array(source[i:i + BPTT], ctx=ctx)
        target = mx.nd.array(source[i + 1:i + 1 + BPTT], ctx=ctx)
        hidden = [h.detach() for h in hidden]
        with mx.autograd.record():
            output, hidden = net(data, hidden)
            L = loss_fn(output, target.reshape((-1,)))
            L.backward()
        grads = [p.grad(ctx) for p in net.collect_params().values()]
        mx.gluon.utils.clip_global_norm(grads, CLIP * BPTT * BATCH)
        trainer.step(BATCH * BPTT)
        losses.append(float(L.mean().asscalar()))
    return losses


def test_tied_lm_parameters_match_jax():
    """One embedding weight shared by the decoder: the same names as JAX,
    and one parameter (not two) in collect_params."""
    nets = [rnn_model(mx, 50, WIDTH, LAYERS, 0.0) for mx in (jmx, tmx)]
    names = [[n[len(net.prefix):] for n in net.collect_params()]
             for net in nets]
    assert names[0] == names[1]
    assert names[1].count("embedding0_weight") == 1
    assert "embedding0_bias" in names[1]
    t = nets[1]
    assert t.decoder.weight is t.encoder.weight
    assert len(names[1]) == 1 + 4 * LAYERS + 1


def test_word_lm_imperative_steps_match_jax():
    source, vocab = _corpus()
    jnet = rnn_model(jmx, vocab, WIDTH, LAYERS, 0.0)
    jnet.initialize(jmx.init.Zero())
    weights = _weights(jnet)
    for n, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(weights[n]))
    want = _train(jmx, jnet, source, jmx.cpu())

    tnet = rnn_model(tmx, vocab, WIDTH, LAYERS, 0.0)
    tnet.initialize(device="cpu")
    load_numpy_params(tnet, weights, prefix=jnet.prefix)
    got = _train(tmx, tnet, source, CPU)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    for n, p in jnet.collect_params().items():
        tp = tnet.collect_params()[tnet.prefix + n[len(jnet.prefix):]]
        np.testing.assert_allclose(tp.data().asnumpy(), p.data().asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_word_lm_dropout_draws_only_in_training():
    """With dropout 0.5 the forward differs between two recorded calls
    (fresh masks) and equals itself in predict mode."""
    source, vocab = _corpus()
    net = rnn_model(tmx, vocab, WIDTH, LAYERS, 0.5)
    net.initialize(tmx.init.Xavier(), device="cpu")
    data = tmx.nd.array(source[:BPTT], ctx=CPU)
    hidden = net.begin_state(batch_size=BATCH, ctx=CPU)
    outs = []
    for _ in range(2):
        with tmx.autograd.record():
            outs.append(net(data, hidden)[0].asnumpy())
    assert not np.array_equal(outs[0], outs[1])
    p1 = net(data, hidden)[0].asnumpy()
    p2 = net(data, hidden)[0].asnumpy()
    np.testing.assert_array_equal(p1, p2)
    assert torch.isfinite(torch.from_numpy(p1)).all()
    assert p1.shape == (BPTT * BATCH, vocab)


# -- the contrib layers --------------------------------------------------------

def _concurrent(mx, hybrid):
    cls = (mx.gluon.contrib.nn.HybridConcurrent if hybrid
           else mx.gluon.contrib.nn.Concurrent)
    net = cls(axis=1)
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(3), mx.gluon.contrib.nn.Identity(),
                mx.gluon.nn.Dense(2, activation="tanh"))
    return net


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CONTRIB = {
    "Concurrent": (lambda mx: _concurrent(mx, False), [_np(0, 4, 5)], True),
    "HybridConcurrent": (lambda mx: _concurrent(mx, True), [_np(0, 4, 5)],
                         True),
    "SyncBatchNorm": (lambda mx: mx.gluon.contrib.nn.SyncBatchNorm(),
                      [_np(1, 4, 3, 5, 5)], True),
    "SyncBatchNorm(predict)": (
        lambda mx: mx.gluon.contrib.nn.SyncBatchNorm(scale=False),
        [_np(1, 4, 3, 5, 5)], False),
    "PixelShuffle1D": (lambda mx: mx.gluon.contrib.nn.PixelShuffle1D(3),
                       [_np(2, 2, 6, 4)], True),
    "PixelShuffle2D": (lambda mx: mx.gluon.contrib.nn.PixelShuffle2D((2, 3)),
                       [_np(3, 2, 12, 3, 4)], True),
    "PixelShuffle3D": (lambda mx: mx.gluon.contrib.nn.PixelShuffle3D(2),
                       [_np(4, 1, 16, 2, 3, 2)], True),
}


@pytest.mark.parametrize("name", sorted(CONTRIB))
def test_contrib_layer_matches_jax(name):
    import jax

    make, inputs, train = CONTRIB[name]
    g, args, weights, rel, _ = _jax_block(make, inputs, train,
                                          init=jmx.init.Zero())
    outs, _, gp, gx = jax.jit(g)(*args)
    got = _port_block(make, inputs, weights, train)
    for a, b in zip(got[0], outs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1], gx):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    for n, v in zip(rel, gp):
        np.testing.assert_allclose(got[2][n], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_sync_batch_norm_on_one_device_only():
    with pytest.raises(NotImplementedError, match="Queue A 4"):
        tmx.gluon.contrib.nn.SyncBatchNorm(axis_name="dp")
    # SparseEmbedding is served now (tests/test_torch_embedding.py)
    assert hasattr(tmx.gluon.contrib.nn, "SparseEmbedding")
