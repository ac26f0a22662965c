// A copy of native/ldl.cpp (the osqp_tpu package's native engine), built by osqp_tpu_torch/native.py.
#include "ldl.h"

#include <algorithm>
#include <queue>
#include <set>

namespace tpuqp {

std::vector<idx> mindeg_order(idx n, const idx* Ap, const idx* Ai) {
  // Elimination-graph minimum-degree ordering (greedy, exact degrees —
  // the simple ancestor of AMD). Declines (returns empty) on problems
  // where the quadratic-time scan or clique growth would hurt; the caller
  // falls back to RCM. Ties break on the smallest index for determinism.
  if (n > 6000) return {};
  std::vector<std::set<idx>> adj(n);
  for (idx j = 0; j < n; ++j)
    for (idx p = Ap[j]; p < Ap[j + 1]; ++p) {
      idx i = Ai[p];
      if (i == j) continue;
      adj[i].insert(j);
      adj[j].insert(i);
    }
  const size_t edge_cap = 8u * 1000u * 1000u;
  size_t edges = 0;
  for (idx j = 0; j < n; ++j) edges += adj[j].size();

  std::vector<idx> perm(n);  // perm[old] = new position
  std::vector<char> done(n, 0);
  for (idx k = 0; k < n; ++k) {
    idx best = -1;
    size_t best_deg = 0;
    for (idx v = 0; v < n; ++v) {
      if (done[v]) continue;
      size_t d = adj[v].size();
      if (best < 0 || d < best_deg) {
        best = v;
        best_deg = d;
      }
    }
    done[best] = 1;
    perm[best] = k;
    // eliminate: neighbors of best become a clique
    std::vector<idx> nb(adj[best].begin(), adj[best].end());
    for (idx a : nb) {
      adj[a].erase(best);
      edges -= 1;
    }
    for (size_t x = 0; x < nb.size(); ++x)
      for (size_t y = x + 1; y < nb.size(); ++y) {
        if (adj[nb[x]].insert(nb[y]).second) {
          adj[nb[y]].insert(nb[x]);
          edges += 2;
        }
      }
    adj[best].clear();
    if (edges > edge_cap) return {};
  }
  return perm;
}

std::vector<idx> amd_order(idx n, const idx* Ap, const idx* Ai) {
  // Approximate-minimum-degree ordering on the quotient graph (the AMD
  // family: eliminated pivots become *elements* whose member lists stand in
  // for the fill clique; neighbor degrees are updated with the classic
  // approximate external-degree bound; indistinguishable variables merge
  // into supervariables; elements wholly covered by the new element are
  // absorbed). Near-linear in practice — no size guard needed, unlike the
  // exact-degree mindeg_order above. Deterministic for a fixed input.
  if (n <= 0) return {};
  // symmetrized adjacency of the upper-triangular input
  std::vector<std::vector<idx>> Avars(n), Aelems(n), Emem(n);
  for (idx j = 0; j < n; ++j)
    for (idx p = Ap[j]; p < Ap[j + 1]; ++p) {
      idx i = Ai[p];
      if (i == j) continue;
      Avars[i].push_back(j);
      Avars[j].push_back(i);
    }

  std::vector<idx> nv(n, 1);        // supervariable weight; 0 = dead/elem
  std::vector<char> is_elem(n, 0);  // node became an element (eliminated)
  std::vector<idx> esize(n, 0);     // weight of an element's live members
  std::vector<idx> deg(n);          // approximate external degree (weights)
  std::vector<idx> member_next(n, -1), member_tail(n);  // supervar chains
  for (idx v = 0; v < n; ++v) member_tail[v] = v;

  // degree buckets (doubly linked)
  std::vector<idx> bhead(n + 1, -1), bnext(n, -1), bprev(n, -1);
  auto bucket_insert = [&](idx v, idx d) {
    bnext[v] = bhead[d];
    bprev[v] = -1;
    if (bhead[d] >= 0) bprev[bhead[d]] = v;
    bhead[d] = v;
  };
  auto bucket_remove = [&](idx v, idx d) {
    if (bprev[v] >= 0) bnext[bprev[v]] = bnext[v];
    else bhead[d] = bnext[v];
    if (bnext[v] >= 0) bprev[bnext[v]] = bprev[v];
  };
  for (idx v = 0; v < n; ++v) {
    deg[v] = (idx)Avars[v].size();  // exact at start (no duplicates)
    if (deg[v] > n - 1) deg[v] = n - 1;
    bucket_insert(v, deg[v]);
  }

  std::vector<idx> stamp(n, -1), wdiff(n, 0);  // per-pivot element scratch
  std::vector<idx> vstamp(n, -1);              // per-pivot variable marks
  std::vector<idx> hash_stamp(n, -1), hash_head(n, -1), hash_next(n, -1);
  std::vector<idx> vhash(n, 0);                // pass-2 bucket per vertex
  // dedicated stamps for the pairwise indistinguishability comparison —
  // these MUST NOT consume `gen`, or the hash buckets built in pass 2
  // (stamped with gen) would be invalidated by the first comparison
  std::vector<idx> cstamp_v(n, -1), cstamp_e(n, -1);
  idx cgen = 0;
  std::vector<idx> Lp;
  std::vector<idx> perm(n);
  idx k = 0, mindeg = 0, gen = 0;

  while (k < n) {
    // --- pick the minimum-approximate-degree supervariable ---
    while (mindeg <= n && bhead[mindeg] < 0) ++mindeg;
    idx p = bhead[mindeg];
    bucket_remove(p, mindeg);
    ++gen;

    // --- form the new element L_p = (A_p ∪ ⋃ L_e) \ {p} ---
    Lp.clear();
    vstamp[p] = gen;
    for (idx v : Avars[p])
      if (nv[v] > 0 && vstamp[v] != gen) {
        vstamp[v] = gen;
        Lp.push_back(v);
      }
    for (idx e : Aelems[p])
      if (is_elem[e] == 1) {
        for (idx v : Emem[e])
          if (nv[v] > 0 && vstamp[v] != gen) {
            vstamp[v] = gen;
            Lp.push_back(v);
          }
        is_elem[e] = 2;  // absorbed into p
        Emem[e].clear();
        Emem[e].shrink_to_fit();
      }
    Avars[p].clear();
    Aelems[p].clear();

    // output p's supervariable members
    idx nvp = nv[p];
    for (idx v = p; v != -1; v = member_next[v]) perm[v] = k++;
    nv[p] = 0;
    is_elem[p] = 1;
    idx degLp = 0;
    for (idx v : Lp) degLp += nv[v];
    esize[p] = degLp;
    Emem[p] = Lp;  // copy (Lp reused next pivot)

    if (Lp.empty()) continue;

    // --- pass 1: prune neighbor lists, set up |L_e \ L_p| counters ---
    for (idx v : Lp) {
      // drop absorbed elements; count |L_e \ L_p| via weight subtraction
      auto& Ev = Aelems[v];
      size_t out = 0;
      for (idx e : Ev) {
        if (is_elem[e] != 1) continue;  // absorbed — drop
        Ev[out++] = e;
        if (stamp[e] != gen) {
          stamp[e] = gen;
          wdiff[e] = esize[e];
        }
        wdiff[e] -= nv[v];
      }
      Ev.resize(out);
      Ev.push_back(p);
      // prune A_v: drop dead vars, members of L_p (now covered by element
      // p), and p itself
      auto& Va = Avars[v];
      out = 0;
      for (idx u : Va)
        if (nv[u] > 0 && vstamp[u] != gen) Va[out++] = u;
      Va.resize(out);
    }

    // --- pass 2: approximate degrees + supervariable hashing ---
    ++gen;  // fresh generation for hash-bucket stamps
    for (idx v : Lp) {
      idx av = 0;
      for (idx u : Avars[v]) av += nv[u];
      idx d = av + (degLp - nv[v]);
      size_t hsh = (size_t)p;
      for (idx e : Aelems[v]) {
        if (e != p) d += (stamp[e] == gen - 1) ? wdiff[e] : esize[e];
        if (e != p) hsh += (size_t)e;
      }
      for (idx u : Avars[v]) hsh += (size_t)u;
      idx cap = n - k > 0 ? (idx)(n - k) : 1;
      idx old_bound = deg[v] + degLp - nv[v];
      if (d > old_bound) d = old_bound;
      if (d > cap) d = cap;
      if (d < 0) d = 0;
      bucket_remove(v, deg[v]);
      deg[v] = d;
      bucket_insert(v, d);
      if (d < mindeg) mindeg = d;
      // hash bucket for indistinguishability detection
      idx h = (idx)(hsh % (size_t)n);
      vhash[v] = h;
      if (hash_stamp[h] != gen) {
        hash_stamp[h] = gen;
        hash_head[h] = -1;
      }
      hash_next[v] = hash_head[h];
      hash_head[h] = v;
    }
    const idx hash_gen = gen;  // bucket stamps belong to this generation

    // --- aggressive absorption: elements fully covered by L_p ---
    for (idx v : Lp) {
      auto& Ev = Aelems[v];
      size_t out = 0;
      for (idx e : Ev) {
        if (e != p && stamp[e] == gen - 1 && wdiff[e] <= 0) {
          if (is_elem[e] == 1) {
            is_elem[e] = 2;
            Emem[e].clear();
            Emem[e].shrink_to_fit();
          }
          continue;
        }
        Ev[out++] = e;
      }
      Ev.resize(out);
    }

    // --- supervariable merging: identical (A_v, E_v) ⇒ merge ---
    for (idx vi = 0; vi < (idx)Lp.size(); ++vi) {
      idx v = Lp[vi];
      if (nv[v] <= 0) continue;
      // the pass-2 bucket was saved per vertex (recomputing it here would
      // disagree with the chains whenever aggressive absorption pruned an
      // element between pass 2 and now)
      idx h = vhash[v];
      if (hash_stamp[h] != hash_gen || hash_head[h] != v) continue;
      // v heads its bucket: compare against the rest of the chain
      for (idx u = hash_next[v]; u != -1; u = hash_next[u]) {
        if (nv[u] <= 0 || u == v) continue;
        if (Avars[u].size() != Avars[v].size()
            || Aelems[u].size() != Aelems[v].size())
          continue;
        // mark v's lists, check u's lists hit only marks (dedicated
        // comparison stamps — see declaration)
        ++cgen;
        for (idx x : Avars[v]) cstamp_v[x] = cgen;
        for (idx x : Aelems[v]) cstamp_e[x] = cgen;
        bool same = true;
        for (idx x : Avars[u])
          if (cstamp_v[x] != cgen) {
            same = false;
            break;
          }
        if (same)
          for (idx x : Aelems[u])
            if (cstamp_e[x] != cgen) {
              same = false;
              break;
            }
        if (!same) continue;
        // merge u into v (weight moves inside shared elements: esize
        // conserved); u's weight no longer counts toward v's external
        // degree
        bucket_remove(u, deg[u]);
        bucket_remove(v, deg[v]);
        deg[v] = deg[v] > nv[u] ? deg[v] - nv[u] : 0;
        bucket_insert(v, deg[v]);
        if (deg[v] < mindeg) mindeg = deg[v];
        member_next[member_tail[v]] = u;
        member_tail[v] = member_tail[u];
        nv[v] += nv[u];
        nv[u] = 0;
        Avars[u].clear();
        Avars[u].shrink_to_fit();
        Aelems[u].clear();
        Aelems[u].shrink_to_fit();
      }
    }
    (void)nvp;
  }
  return perm;
}

std::vector<idx> rcm_order(idx n, const idx* Ap, const idx* Ai) {
  // Build the full (symmetrized) adjacency from the upper-triangular pattern.
  std::vector<idx> deg(n, 0);
  for (idx j = 0; j < n; ++j)
    for (idx p = Ap[j]; p < Ap[j + 1]; ++p) {
      idx i = Ai[p];
      if (i == j) continue;
      deg[i] += 1;
      deg[j] += 1;
    }
  std::vector<idx> ptr(n + 1, 0);
  for (idx j = 0; j < n; ++j) ptr[j + 1] = ptr[j] + deg[j];
  std::vector<idx> adj(ptr[n]);
  std::vector<idx> fill(ptr.begin(), ptr.end() - 1);
  for (idx j = 0; j < n; ++j)
    for (idx p = Ap[j]; p < Ap[j + 1]; ++p) {
      idx i = Ai[p];
      if (i == j) continue;
      adj[fill[i]++] = j;
      adj[fill[j]++] = i;
    }

  std::vector<idx> order;
  order.reserve(n);
  std::vector<char> visited(n, 0);
  std::vector<idx> nbrs;
  for (idx seed_scan = 0; seed_scan < n; ++seed_scan) {
    if (visited[seed_scan]) continue;
    // start each component from a minimum-degree node
    idx seed = seed_scan;
    // BFS (Cuthill-McKee): neighbors visited in increasing degree
    std::queue<idx> bfs;
    bfs.push(seed);
    visited[seed] = 1;
    while (!bfs.empty()) {
      idx v = bfs.front();
      bfs.pop();
      order.push_back(v);
      nbrs.clear();
      for (idx p = ptr[v]; p < ptr[v + 1]; ++p)
        if (!visited[adj[p]]) nbrs.push_back(adj[p]);
      std::sort(nbrs.begin(), nbrs.end(),
                [&](idx a, idx b) { return deg[a] < deg[b]; });
      for (idx w : nbrs) {
        visited[w] = 1;
        bfs.push(w);
      }
    }
  }
  // reverse ordering; perm[old] = new
  std::vector<idx> perm(n);
  for (idx k = 0; k < n; ++k) perm[order[n - 1 - k]] = k;
  return perm;
}

// Elimination tree and column counts for upper-triangular CSC input
// (Liu's algorithm with path compression via "ancestor" pointers).
bool ldl_symbolic(idx n, const idx* Ap, const idx* Ai, LDLSymbolic& S) {
  S.n = n;
  S.etree.assign(n, -1);
  std::vector<idx> ancestor(n, -1);
  bool diag_ok = true;
  for (idx j = 0; j < n; ++j) {
    bool has_diag = false;
    for (idx p = Ap[j]; p < Ap[j + 1]; ++p) {
      idx i = Ai[p];
      if (i == j) has_diag = true;
      if (i >= j) continue;  // only strictly-upper entries drive the tree
      // walk from i to the root with path compression
      while (i != -1 && i < j) {
        idx next = ancestor[i];
        ancestor[i] = j;
        if (next == -1) S.etree[i] = j;
        if (next == -1 || next == j) break;
        i = next;
      }
    }
    if (!has_diag) diag_ok = false;
  }
  // Column counts of L via per-column etree reach marking.
  S.Lnz.assign(n, 0);
  std::vector<idx> mark(n, -1);
  for (idx j = 0; j < n; ++j) {
    mark[j] = j;
    for (idx p = Ap[j]; p < Ap[j + 1]; ++p) {
      idx i = Ai[p];
      if (i >= j) continue;
      // follow etree path from i until marked this column
      while (mark[i] != j) {
        mark[i] = j;
        S.Lnz[i] += 1;  // L(j, i) exists
        i = S.etree[i];
        if (i == -1) break;
      }
    }
  }
  S.Lp.assign(n + 1, 0);
  for (idx j = 0; j < n; ++j) S.Lp[j + 1] = S.Lp[j] + S.Lnz[j];
  S.total_nz = S.Lp[n];
  return diag_ok;
}

bool ldl_numeric(idx n, const idx* Ap, const idx* Ai, const double* Ax,
                 const LDLSymbolic& S, LDLFactor& F) {
  F.Li.assign(S.total_nz, 0);
  F.Lx.assign(S.total_nz, 0.0);
  F.D.assign(n, 0.0);
  F.Dinv.assign(n, 0.0);
  F.num_pos = 0;

  std::vector<double> y(n, 0.0);      // dense accumulator for row j of L
  std::vector<idx> pattern(n, 0);     // reach stack
  std::vector<idx> mark(n, -1);
  std::vector<idx> next_in_col(n, 0); // fill position per column of L
  for (idx j = 0; j < n; ++j) next_in_col[j] = S.Lp[j];

  for (idx j = 0; j < n; ++j) {
    // --- compute the nonzero pattern of row j of L (reach in etree) ---
    idx top = n;
    double djj = 0.0;
    mark[j] = j;  // stop every etree walk at the diagonal node
    for (idx p = Ap[j]; p < Ap[j + 1]; ++p) {
      idx i = Ai[p];
      if (i > j) return false;  // input must be upper triangular
      if (i == j) {
        djj = Ax[p];
        continue;
      }
      y[i] += Ax[p];  // scatter A(i, j)
      idx len = 0;
      while (mark[i] != j) {
        pattern[len++] = i;
        mark[i] = j;
        i = S.etree[i];
        if (i == -1) break;
      }
      // reverse the discovered path onto the stack (topological order)
      while (len > 0) pattern[--top] = pattern[--len];
    }

    // --- sparse triangular solve: L(0:j,0:j) y = A(0:j,j), then form row ---
    for (idx t = top; t < n; ++t) {
      idx k = pattern[t];
      double yk = y[k];
      y[k] = 0.0;
      // apply column k of L to the accumulator
      for (idx p = S.Lp[k]; p < next_in_col[k]; ++p) {
        y[F.Li[p]] -= F.Lx[p] * yk;
      }
      double l_jk = yk * F.Dinv[k];
      djj -= l_jk * yk;
      // append L(j, k) to column k
      F.Li[next_in_col[k]] = j;
      F.Lx[next_in_col[k]] = l_jk;
      next_in_col[k] += 1;
    }

    if (djj == 0.0) return false;
    F.D[j] = djj;
    F.Dinv[j] = 1.0 / djj;
    if (djj > 0) F.num_pos += 1;
  }
  return true;
}

void ldl_solve(const LDLSymbolic& S, const LDLFactor& F, double* x) {
  const idx n = S.n;
  // forward: L y = b
  for (idx j = 0; j < n; ++j) {
    double xj = x[j];
    for (idx p = S.Lp[j]; p < S.Lp[j + 1]; ++p) {
      x[F.Li[p]] -= F.Lx[p] * xj;
    }
  }
  // diagonal
  for (idx j = 0; j < n; ++j) x[j] *= F.Dinv[j];
  // backward: L' x = y
  for (idx j = n - 1; j >= 0; --j) {
    double xj = x[j];
    for (idx p = S.Lp[j]; p < S.Lp[j + 1]; ++p) {
      xj -= F.Lx[p] * x[F.Li[p]];
    }
    x[j] = xj;
  }
}

}  // namespace tpuqp
