"""The KGWAS model, its loss and its optimizer in plain PyTorch, from the
reference's description (``model.py``, ``conv.py``, ``kgwas.py``):

  * per node type a 3-layer MLP encoder, h = W3 relu(W2 relu(W1 x + b1) +
    b2) + b3 (one MLP shared by the three GO types);
  * per layer a HeteroConv with aggr sum over relations of PyG GATConv
    (one head, bipartite lin_src / lin_dst, lin_src at both ends of a
    homogeneous relation, no added self loops, negative slope 0.2):
    a_s = (h_s W_src^T) att_src, a_d = (h_d W_dst^T) att_dst, per edge
    e = leaky_relu(a_s[src] + a_d[dst]), alpha = softmax of e over the
    edges into each destination (PyG's: max shift, + 1e-16), out[dst] +=
    alpha x_src[src], plus the relation's bias; then ReLU;
  * the head relu(h_SNP W^T + b), one channel;
  * the loss mean(w[b] (pred[b] - y[b])^2) on a batch b, w the LDSC weights;
  * torch Adam's update with coupled weight decay (g + wd p), betas (0.9,
    0.999), eps 1e-8 outside the square root; a leaf with no path to the
    loss gets gradient 0, so weight decay alone moves it.

Only the groups whose output reaches the head run (graph.live_groups);
the others change no prediction. The message sum runs in blocks of edges
(``GatherScatter``), so that no [E, D] table is held for the backward.
"""
from __future__ import annotations

import torch

from ..inputs.params import relation_key
from .graph import live_groups

EDGE_BLOCK = 1 << 22
NEG_SLOPE = 0.2


class GatherScatter(torch.autograd.Function):
    """out [n_dst, D] = sum over edges of alpha_e xs[src_e] into dst_e, in
    blocks of EDGE_BLOCK edges; the backward recomputes each block's rows."""

    @staticmethod
    def forward(ctx, xs, alpha, src, dst, n_dst):
        out = xs.new_zeros((n_dst, xs.shape[1]))
        for a in range(0, src.numel(), EDGE_BLOCK):
            s, d = src[a:a + EDGE_BLOCK], dst[a:a + EDGE_BLOCK]
            out.index_add_(0, d, xs.index_select(0, s)
                           * alpha[a:a + EDGE_BLOCK, None])
        ctx.save_for_backward(xs, alpha, src, dst)
        return out

    @staticmethod
    def backward(ctx, g):
        xs, alpha, src, dst = ctx.saved_tensors
        d_xs = torch.zeros_like(xs)
        d_alpha = torch.empty_like(alpha)
        for a in range(0, src.numel(), EDGE_BLOCK):
            s, d = src[a:a + EDGE_BLOCK], dst[a:a + EDGE_BLOCK]
            gd = g.index_select(0, d)
            d_xs.index_add_(0, s, gd * alpha[a:a + EDGE_BLOCK, None])
            d_alpha[a:a + EDGE_BLOCK] = (gd * xs.index_select(0, s)).sum(1)
        return d_xs, d_alpha, None, None, None


def segment_softmax(e, dst, n_dst):
    """PyG's softmax over the edges into each destination."""
    m = torch.full((n_dst,), float("-inf"), device=e.device, dtype=e.dtype)
    m = m.scatter_reduce(0, dst, e.detach(), "amax", include_self=True)
    ex = torch.exp(e - m[dst])
    den = torch.zeros((n_dst,), device=e.device, dtype=e.dtype)
    den = den.index_add(0, dst, ex) + 1e-16
    return ex / den[dst]


def mlp(p, prefix, x):
    h = torch.relu(x @ p[f"{prefix}.FC_hidden.weight"].T
                   + p[f"{prefix}.FC_hidden.bias"])
    h = torch.relu(h @ p[f"{prefix}.FC_hidden2.weight"].T
                   + p[f"{prefix}.FC_hidden2.bias"])
    return h @ p[f"{prefix}.FC_output.weight"].T + p[f"{prefix}.FC_output.bias"]


def encoder_of(ntype):
    """The encoder of a node type: one MLP shared by the GO types."""
    return {"SNP": "snp_feat_mlp", "Gene": "gene_feat_mlp"}.get(
        ntype, "go_feat_mlp")


def gat(p, prefix, h_src, h_dst, src, dst, n_dst):
    w_src = p[f"{prefix}.lin_src.weight"]
    w_dst = p.get(f"{prefix}.lin_dst.weight", w_src)
    xs = h_src @ w_src.T
    a_s = (xs * p[f"{prefix}.att_src"][0, 0]).sum(-1)
    a_d = ((h_dst @ w_dst.T) * p[f"{prefix}.att_dst"][0, 0]).sum(-1)
    e = torch.nn.functional.leaky_relu(a_s[src] + a_d[dst], NEG_SLOPE)
    alpha = segment_softmax(e, dst, n_dst)
    return GatherScatter.apply(xs, alpha, src, dst, n_dst) + p[f"{prefix}.bias"]


def forward(p, feats, rels, num_nodes, layers, relu_head=True):
    """Predictions [n_snp] of every SNP. p: name -> tensor; feats: node
    type -> [N, D]; rels: (src, rel, dst) -> (src, dst) int64."""
    per_layer, encoded = live_groups(rels, layers)
    h = {t: mlp(p, encoder_of(t), feats[t]) for t in sorted(encoded)}
    for li, live in enumerate(per_layer):
        out = {}
        for d in live:
            acc = None
            for rt, (src, dst) in rels.items():
                if rt[2] != d:
                    continue
                o = gat(p, f"convs.{li}.convs.{relation_key(rt)}",
                        h[rt[0]], h[d], src, dst, num_nodes[d])
                acc = o if acc is None else acc + o
            out[d] = torch.relu(acc)
        h = out
    logits = (h["SNP"] @ p["lin.weight"].T + p["lin.bias"])[:, 0]
    return torch.relu(logits) if relu_head else logits


def loss_fn(pred, batch, y, w):
    return torch.mean(w[batch] * (pred[batch] - y[batch]) ** 2)


class Adam:
    """torch.optim.Adam's arithmetic, written out (coupled weight decay)."""

    def __init__(self, params: dict, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.p = params
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k] + self.wd * p
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            p.sub_(self.lr * (self.m[k] / c1) / denom)


def train_steps(params, feats, rels, num_nodes, layers, batches, y, w,
                lr, weight_decay, relu_head=True, keep=()):
    """len(batches) optimizer steps from params (a dict of leaves, updated
    in place). Returns (losses, the first step's gradients as the
    optimizer gets them (before weight decay), {t: the parameters' change
    after t steps} for each t in keep and for the last step)."""
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, lr, weight_decay)
    losses, first_grads, changes = [], None, {}
    for t, b in enumerate(batches, 1):
        leaves = {k: v.detach().requires_grad_(True) for k, v in
                  params.items()}
        loss = loss_fn(forward(leaves, feats, rels, num_nodes, layers,
                               relu_head), b, y, w)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        if first_grads is None:
            first_grads = {k: g.clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
        if t in keep or t == len(batches):
            changes[t] = {k: params[k] - start[k] for k in params}
    return losses, first_grads, changes
