// bdd_host — native host-side preprocessing for bdd_tpu_torch: the port's own
// copy of native/bdd_host.cpp, with the CPU solver's per-thread delta scratch
// sized per call (CpuSolver::compute_delta).
//
// Covers the latency-sensitive CPU pipeline that the reference implements in
// C++ (SURVEY.md §7 "keep in C++"): LP parsing (ref: src/ILP/ILP_parser.cpp),
// the ILP model with variable orderings (ref: include/ILP/ILP_input.h),
// inequality->BDD construction by layered DP with bottom-up state merging
// (same canonical result as the interval dedup of src/bdd_conversion/
// lineq_bdd.cpp), quasi-reduction (ref: bdd_collection make_qbdd) and the
// uniform-bucket flattening feeding the device solver. Exposed as a C ABI for
// ctypes (no pybind11 in this environment).
//
// Single translation unit by design: the whole pipeline shares one arena-ish
// set of std containers, compiles in seconds, and keeps the ABI surface tiny.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <numeric>
#include <queue>
#include <stdexcept>
#include <string>
#include <atomic>
#include <limits>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace bh {

enum class Ineq : uint8_t { LEQ = 0, GEQ = 1, EQ = 2 };

struct Constraint {
    std::vector<int64_t> coeffs;
    std::vector<int32_t> vars;  // degree-1 view (valid when monos empty)
    // nonlinear terms: monos[i] lists the distinct vars of term i (size>=2
    // for true products); empty when the constraint is linear. Linearized
    // away by linearize_nonlinear before BDD construction (Fortet; mirrors
    // bdd_tpu/bdd/preprocessor._linearize_nonlinear and ref
    // convert_pb_to_bdd.h nonlinear path).
    std::vector<std::vector<int32_t>> monos;
    Ineq ineq = Ineq::LEQ;
    int64_t rhs = 0;
    std::string name;

    bool is_linear() const { return monos.empty(); }
};

struct Ilp {
    std::vector<std::string> var_names;
    std::unordered_map<std::string, int32_t> var_index;
    std::vector<double> objective;
    double constant = 0.0;
    std::vector<Constraint> constraints;
    std::vector<std::vector<int32_t>> coalesce_sets;  // constraint indices

    int32_t get_or_create(const std::string& name) {
        auto it = var_index.find(name);
        if (it != var_index.end()) return it->second;
        int32_t idx = (int32_t)var_names.size();
        var_names.push_back(name);
        var_index.emplace(name, idx);
        objective.push_back(0.0);
        return idx;
    }
};

// ------------------------------------------------------------------ parsing
// Hand-rolled tokenizer for the reference LP dialect (Minimize / Subject To /
// Bounds / Binaries / Coalesce / End, '\' comments, optional 'name:' prefixes,
// multi-line constraints). Monomial products are rejected (python fallback).
struct Parser {
    const char* p;
    const char* end;
    std::string err;

    explicit Parser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    }
    void skip_ws_nl() {
        for (;;) {
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) p++;
            if (p < end && *p == '\\') {  // comment to end of line
                while (p < end && *p != '\n') p++;
            } else
                break;
        }
    }
    bool at_eol() {
        skip_ws();
        return p >= end || *p == '\n';
    }
    static bool ident_char(char c) {
        return std::isalnum((unsigned char)c) || strchr("_-/(){},#;[].'@", c) != nullptr;
    }
    bool read_ident(std::string& out) {
        skip_ws();
        if (p >= end || !std::isalpha((unsigned char)*p)) return false;
        const char* s = p;
        while (p < end && ident_char(*p)) p++;
        out.assign(s, p - s);
        return true;
    }
    bool peek_keyword(const char* kw) {
        skip_ws();
        size_t n = strlen(kw);
        if ((size_t)(end - p) < n) return false;
        for (size_t i = 0; i < n; ++i)
            if (std::tolower((unsigned char)p[i]) != std::tolower((unsigned char)kw[i]))
                return false;
        // must end at identifier boundary
        if ((size_t)(end - p) > n && ident_char(p[n]) ) return false;
        return true;
    }
    bool eat_keyword(const char* kw) {
        if (!peek_keyword(kw)) return false;
        p += strlen(kw);
        return true;
    }
    bool read_number(double& out) {
        skip_ws();
        char* q = nullptr;
        double v = std::strtod(p, &q);
        if (q == p) return false;
        p = q;
        out = v;
        return true;
    }
};

inline bool parse_lp(const std::string& text, Ilp& ilp, std::string& err) {
    Parser ps(text);
    ps.skip_ws_nl();
    if (!ps.eat_keyword("minimize") && !ps.eat_keyword("min")) {
        err = "expected Minimize";
        return false;
    }
    // objective terms until "Subject To"
    ps.skip_ws_nl();
    while (!ps.peek_keyword("subject to") && !ps.peek_keyword("st")) {
        double sign = 1.0;
        ps.skip_ws_nl();
        if (ps.p < ps.end && (*ps.p == '+' || *ps.p == '-')) {
            sign = (*ps.p == '-') ? -1.0 : 1.0;
            ps.p++;
        }
        ps.skip_ws_nl();
        double coeff = 1.0;
        bool have_coeff = ps.read_number(coeff);
        ps.skip_ws();
        if (ps.p < ps.end && *ps.p == '*') ps.p++;
        std::string var;
        if (!ps.read_ident(var)) {
            if (have_coeff) {  // trailing constant
                ilp.constant += sign * coeff;
                ps.skip_ws_nl();
                continue;
            }
            err = "objective: expected variable";
            return false;
        }
        ilp.objective[ilp.get_or_create(var)] += sign * coeff;
        ps.skip_ws_nl();
        if (ps.p >= ps.end) {
            err = "expected Subject To";
            return false;
        }
    }
    if (!ps.eat_keyword("subject to")) ps.eat_keyword("st");

    std::vector<int32_t> zero_fix, one_fix;

    // constraints
    for (;;) {
        ps.skip_ws_nl();
        if (ps.p >= ps.end) {
            err = "unexpected EOF (missing End)";
            return false;
        }
        if (ps.peek_keyword("end") || ps.peek_keyword("bounds") ||
            ps.peek_keyword("binaries") || ps.peek_keyword("generals") ||
            ps.peek_keyword("coalesce"))
            break;
        Constraint c;
        // optional name: ident ':'
        {
            const char* save = ps.p;
            std::string nm;
            if (ps.read_ident(nm)) {
                ps.skip_ws();
                if (ps.p < ps.end && *ps.p == ':') {
                    ps.p++;
                    c.name = nm;
                } else {
                    ps.p = save;
                }
            }
        }
        // terms until inequality sign
        int64_t side_constant = 0;
        for (;;) {
            ps.skip_ws_nl();
            if (ps.p < ps.end && (*ps.p == '<' || *ps.p == '>' || *ps.p == '=')) break;
            double sign = 1.0;
            if (ps.p < ps.end && (*ps.p == '+' || *ps.p == '-')) {
                sign = (*ps.p == '-') ? -1.0 : 1.0;
                ps.p++;
            }
            ps.skip_ws_nl();
            double coeff = 1.0;
            bool have_coeff = ps.read_number(coeff);
            ps.skip_ws();
            if (ps.p < ps.end && *ps.p == '*') ps.p++;
            std::string var;
            if (!ps.read_ident(var)) {
                if (have_coeff) {
                    double sc0 = sign * coeff;
                    if (sc0 != std::llround(sc0)) {
                        // python parser keeps fractional constants exact;
                        // rounding here would silently change the model
                        err = "non-integral additive constant";
                        return false;
                    }
                    side_constant += (int64_t)std::llround(sc0);
                    continue;
                }
                err = "constraint: expected variable near '" +
                      std::string(ps.p, std::min<size_t>(20, ps.end - ps.p)) + "'";
                return false;
            }
            // monomial chain: var (* var)* — degree>=2 terms recorded in
            // c.monos (Fortet-linearized before BDD construction)
            std::vector<int32_t> mono{ilp.get_or_create(var)};
            for (;;) {
                ps.skip_ws();
                if (!(ps.p < ps.end && *ps.p == '*')) break;
                ps.p++;
                std::string v2;
                if (!ps.read_ident(v2)) {
                    err = "monomial: expected variable after '*'";
                    return false;
                }
                mono.push_back(ilp.get_or_create(v2));
            }
            double sc = sign * coeff;
            if (sc != std::llround(sc)) {
                err = "non-integral constraint coefficient";
                return false;
            }
            c.coeffs.push_back((int64_t)std::llround(sc));
            c.vars.push_back(mono[0]);
            if (!c.monos.empty() || mono.size() > 1) {
                // switch this constraint to monomial form (backfill earlier
                // linear terms)
                if (c.monos.empty())
                    for (size_t i = 0; i + 1 < c.vars.size(); ++i)
                        c.monos.push_back({c.vars[i]});
                c.monos.push_back(std::move(mono));
            }
        }
        // inequality
        if (ps.p < ps.end && *ps.p == '<') {
            ps.p++;
            if (ps.p < ps.end && *ps.p == '=') ps.p++;
            c.ineq = Ineq::LEQ;
        } else if (ps.p < ps.end && *ps.p == '>') {
            ps.p++;
            if (ps.p < ps.end && *ps.p == '=') ps.p++;
            c.ineq = Ineq::GEQ;
        } else {
            ps.p++;
            c.ineq = Ineq::EQ;
        }
        double rhs;
        if (!ps.read_number(rhs)) {
            err = "constraint: expected rhs";
            return false;
        }
        if (rhs != std::llround(rhs)) {
            err = "non-integral rhs";
            return false;
        }
        c.rhs = (int64_t)std::llround(rhs) - side_constant;
        ilp.constraints.push_back(std::move(c));
    }

    // trailing sections
    for (;;) {
        ps.skip_ws_nl();
        if (ps.p >= ps.end) break;
        if (ps.eat_keyword("end")) break;
        if (ps.eat_keyword("bounds")) {
            for (;;) {
                ps.skip_ws_nl();
                if (ps.peek_keyword("end") || ps.peek_keyword("binaries") ||
                    ps.peek_keyword("generals") || ps.peek_keyword("coalesce") ||
                    ps.p >= ps.end)
                    break;
                // forms: x = 0|1 ; x <= 0|1 ; 0|1 <= x [<= 0|1]
                double num;
                const char* save = ps.p;
                if (ps.read_number(num)) {
                    ps.skip_ws();
                    if (ps.p + 1 < ps.end && ps.p[0] == '<' && ps.p[1] == '=') {
                        ps.p += 2;
                        if (num != 0 && num != 1) {
                            // the python parser only accepts 0/1 bounds and
                            // raises otherwise — mirror, don't misinterpret
                            err = "bounds: non-binary lower bound";
                            return false;
                        }
                        std::string var;
                        if (!ps.read_ident(var)) { err = "bounds: expected var"; return false; }
                        int32_t v = ilp.get_or_create(var);
                        if (num == 1) one_fix.push_back(v);
                        ps.skip_ws();
                        if (ps.p + 1 < ps.end && ps.p[0] == '<' && ps.p[1] == '=') {
                            ps.p += 2;
                            double ub;
                            if (!ps.read_number(ub) || (ub != 0 && ub != 1)) {
                                err = "bounds: non-binary upper bound";
                                return false;
                            }
                            if (ub == 0) zero_fix.push_back(v);
                        }
                        continue;
                    }
                    ps.p = save;
                }
                std::string var;
                if (!ps.read_ident(var)) { err = "bounds: parse error"; return false; }
                int32_t v = ilp.get_or_create(var);
                ps.skip_ws();
                if (ps.p < ps.end && *ps.p == '=') {
                    ps.p++;
                    double val;
                    if (!ps.read_number(val)) { err = "bounds: expected value"; return false; }
                    if (val != 0 && val != 1) {
                        err = "bounds: non-binary fixation";
                        return false;
                    }
                    (val == 1 ? one_fix : zero_fix).push_back(v);
                } else if (ps.p + 1 < ps.end && ps.p[0] == '<' && ps.p[1] == '=') {
                    ps.p += 2;
                    double ub;
                    if (!ps.read_number(ub)) { err = "bounds: expected bound"; return false; }
                    if (ub != 0 && ub != 1) {
                        err = "bounds: non-binary upper bound";
                        return false;
                    }
                    if (ub == 0) zero_fix.push_back(v);
                } else {
                    err = "bounds: parse error";
                    return false;
                }
            }
            continue;
        }
        if (ps.eat_keyword("binaries") || ps.eat_keyword("generals") ||
            ps.eat_keyword("binary") || ps.eat_keyword("general")) {
            std::string tmp;
            for (;;) {
                ps.skip_ws_nl();
                if (ps.peek_keyword("end") || ps.peek_keyword("bounds") ||
                    ps.peek_keyword("coalesce") || ps.p >= ps.end)
                    break;
                if (!ps.read_ident(tmp)) break;
            }
            continue;
        }
        if (ps.eat_keyword("coalesce")) {
            // one group per line: constraint names to meld into one BDD
            std::unordered_map<std::string, int32_t> con_idx;
            for (size_t ci = 0; ci < ilp.constraints.size(); ++ci)
                if (!ilp.constraints[ci].name.empty())
                    con_idx[ilp.constraints[ci].name] = (int32_t)ci;
            for (;;) {
                ps.skip_ws_nl();
                if (ps.peek_keyword("end") || ps.peek_keyword("bounds") ||
                    ps.peek_keyword("binaries") || ps.peek_keyword("generals") ||
                    ps.p >= ps.end)
                    break;
                std::vector<int32_t> group;
                for (;;) {
                    ps.skip_ws();
                    if (ps.p >= ps.end || *ps.p == '\n') break;
                    std::string nm;
                    if (!ps.read_ident(nm)) { err = "coalesce: expected name"; return false; }
                    auto it = con_idx.find(nm);
                    if (it == con_idx.end()) {
                        err = "coalesce: unknown constraint '" + nm + "'";
                        return false;
                    }
                    group.push_back(it->second);
                }
                if (group.size() > 1) ilp.coalesce_sets.push_back(std::move(group));
            }
            continue;
        }
        err = "unexpected content near '" +
              std::string(ps.p, std::min<size_t>(20, ps.end - ps.p)) + "'";
        return false;
    }

    // apply fixations (ref: ILP_parser.cpp:461 -> ilp.reduce)
    if (!zero_fix.empty() || !one_fix.empty()) {
        std::vector<int8_t> fixed(ilp.var_names.size(), -1);
        for (int32_t v : zero_fix) fixed[v] = 0;
        for (int32_t v : one_fix) fixed[v] = 1;
        Ilp out;
        std::vector<int32_t> remap(ilp.var_names.size(), -1);
        for (size_t v = 0; v < ilp.var_names.size(); ++v) {
            if (fixed[v] < 0) {
                remap[v] = out.get_or_create(ilp.var_names[v]);
                out.objective[remap[v]] = ilp.objective[v];
            } else if (fixed[v] == 1) {
                out.constant += ilp.objective[v];
            }
        }
        out.constant += ilp.constant;
        for (auto& c : ilp.constraints) {
            Constraint nc;
            nc.ineq = c.ineq;
            nc.rhs = c.rhs;
            nc.name = c.name;
            if (c.is_linear()) {
                for (size_t i = 0; i < c.vars.size(); ++i) {
                    int32_t v = c.vars[i];
                    if (fixed[v] < 0) {
                        nc.coeffs.push_back(c.coeffs[i]);
                        nc.vars.push_back(remap[v]);
                    } else if (fixed[v] == 1) {
                        nc.rhs -= c.coeffs[i];
                    }
                }
            } else {
                for (size_t i = 0; i < c.monos.size(); ++i) {
                    std::vector<int32_t> m;
                    bool zero = false;
                    for (int32_t v : c.monos[i]) {
                        if (fixed[v] == 0) { zero = true; break; }
                        if (fixed[v] < 0) m.push_back(remap[v]);
                        // fixed == 1: drop from the product
                    }
                    if (zero) continue;
                    if (m.empty()) {  // whole product fixed to 1
                        nc.rhs -= c.coeffs[i];
                        continue;
                    }
                    nc.coeffs.push_back(c.coeffs[i]);
                    nc.vars.push_back(m[0]);
                    nc.monos.push_back(std::move(m));
                }
                if (std::all_of(nc.monos.begin(), nc.monos.end(),
                                [](const std::vector<int32_t>& m) {
                                    return m.size() == 1;
                                }))
                    nc.monos.clear();
            }
            out.constraints.push_back(std::move(nc));
        }
        out.coalesce_sets = std::move(ilp.coalesce_sets);
        ilp = std::move(out);
    }
    return true;
}

// ----------------------------------------------------- normalize + preprocess
// Monomial-aware normalize: merge terms by (sorted, deduped) monomial key,
// drop zeros, sort terms by key lexicographically (order parity with
// ilp/model.Constraint.normalize so the Fortet product-variable creation
// order matches the python pipeline).
inline void normalize(Ilp& ilp) {
    for (auto& c : ilp.constraints) {
        std::map<std::vector<int32_t>, int64_t> merged;
        if (c.is_linear()) {
            for (size_t i = 0; i < c.vars.size(); ++i)
                merged[{c.vars[i]}] += c.coeffs[i];
        } else {
            for (size_t i = 0; i < c.monos.size(); ++i) {
                std::vector<int32_t> key = c.monos[i];
                if (key.size() > 1) {
                    std::sort(key.begin(), key.end());
                    key.erase(std::unique(key.begin(), key.end()), key.end());
                }
                merged[key] += c.coeffs[i];
            }
        }
        c.coeffs.clear();
        c.vars.clear();
        c.monos.clear();
        bool nonlinear = false;
        for (auto& [key, coeff] : merged)
            if (coeff != 0 && key.size() > 1) nonlinear = true;
        for (auto& [key, coeff] : merged) {
            if (coeff == 0) continue;
            c.coeffs.push_back(coeff);
            c.vars.push_back(key[0]);
            if (nonlinear) c.monos.push_back(key);
        }
    }
}

// Fortet linearization of degree>=2 monomials: one product variable per
// distinct key with linking constraints y<=x_v (each v) and
// y >= sum x_v - (k-1), appended AFTER the main constraints so coalesce
// indices stay valid. Mirrors bdd/preprocessor._linearize_nonlinear
// (creation-order parity: constraints in order, terms in normalized order).
inline void linearize_nonlinear(Ilp& ilp) {
    bool any = false;
    for (auto& c : ilp.constraints)
        if (!c.is_linear()) any = true;
    if (!any) return;
    std::map<std::vector<int32_t>, int32_t> prod_var;
    std::vector<Constraint> links;
    for (auto& c : ilp.constraints) {
        if (c.is_linear()) continue;
        std::vector<int64_t> coeffs;
        std::vector<int32_t> vars;
        for (size_t i = 0; i < c.monos.size(); ++i) {
            const auto& m = c.monos[i];
            if (m.size() == 1) {
                coeffs.push_back(c.coeffs[i]);
                vars.push_back(m[0]);
                continue;
            }
            // keys are sorted+deduped by normalize
            auto it = prod_var.find(m);
            int32_t y;
            if (it != prod_var.end()) {
                y = it->second;
            } else {
                std::string nm = "prod_";
                for (size_t k = 0; k < m.size(); ++k)
                    nm += (k ? "_" : "") + std::to_string(m[k]);
                y = ilp.get_or_create(nm);
                prod_var.emplace(m, y);
                for (int32_t v : m) {
                    Constraint lc;
                    lc.coeffs = {1, -1};
                    lc.vars = {y, v};
                    lc.ineq = Ineq::LEQ;
                    lc.rhs = 0;
                    links.push_back(std::move(lc));
                }
                Constraint gc;
                gc.coeffs.assign(m.size() + 1, -1);
                gc.coeffs[0] = 1;
                gc.vars = m;
                gc.vars.insert(gc.vars.begin(), y);
                gc.ineq = Ineq::GEQ;
                gc.rhs = -(int64_t)(m.size() - 1);
                links.push_back(std::move(gc));
            }
            coeffs.push_back(c.coeffs[i]);
            vars.push_back(y);
        }
        c.coeffs = std::move(coeffs);
        c.vars = std::move(vars);
        c.monos.clear();
    }
    for (auto& lc : links) ilp.constraints.push_back(std::move(lc));
}

// returns false on trivial infeasibility (ref: ILP_input.cpp:300-389)
inline bool preprocess(Ilp& ilp) {
    std::vector<Constraint> kept;
    std::unordered_map<int32_t, int32_t> old_to_new;
    int32_t idx = 0;
    for (auto& c : ilp.constraints) {
        bool remove = false;
        if (c.vars.empty()) {
            if (c.ineq == Ineq::LEQ && c.rhs < 0) return false;
            if (c.ineq == Ineq::GEQ && c.rhs > 0) return false;
            if (c.ineq == Ineq::EQ && c.rhs != 0) return false;
            remove = true;
        } else if (c.vars.size() == 1) {
            int64_t coeff = c.coeffs[0];
            if (c.ineq == Ineq::LEQ) {
                if (std::min<int64_t>(coeff, 0) > c.rhs) return false;
                if (std::max<int64_t>(coeff, 0) <= c.rhs) remove = true;
            } else if (c.ineq == Ineq::GEQ) {
                if (std::max<int64_t>(coeff, 0) < c.rhs) return false;
                if (std::min<int64_t>(coeff, 0) >= c.rhs) remove = true;
            } else {
                if (c.rhs != 0 && c.rhs != coeff) return false;
            }
        }
        if (!remove) {
            old_to_new[idx] = (int32_t)kept.size();
            kept.push_back(std::move(c));
        }
        ++idx;
    }
    ilp.constraints = std::move(kept);
    // remap coalesce groups over the surviving constraints
    std::vector<std::vector<int32_t>> cs;
    for (auto& s : ilp.coalesce_sets) {
        std::vector<int32_t> ns;
        for (int32_t i : s) {
            auto it = old_to_new.find(i);
            if (it != old_to_new.end()) ns.push_back(it->second);
        }
        if (ns.size() > 1) cs.push_back(std::move(ns));
    }
    ilp.coalesce_sets = std::move(cs);
    return true;
}

// ---------------------------------------------------------------- orderings
inline std::vector<std::vector<int32_t>> adjacency(const Ilp& ilp) {
    size_t n = ilp.var_names.size();
    std::vector<std::unordered_set<int32_t>> adj(n);
    for (auto& c : ilp.constraints) {
        std::vector<int32_t> union_vars;
        if (!c.is_linear()) {  // union of monomial supports, first-seen order
            std::unordered_set<int32_t> seen;
            for (auto& m : c.monos)
                for (int32_t v : m)
                    if (seen.insert(v).second) union_vars.push_back(v);
        }
        const auto& vs = c.is_linear() ? c.vars : union_vars;
        if (vs.size() > 64) {
            for (size_t i = 0; i + 1 < vs.size(); ++i) {
                adj[vs[i]].insert(vs[i + 1]);
                adj[vs[i + 1]].insert(vs[i]);
            }
        } else {
            for (size_t i = 0; i < vs.size(); ++i)
                for (size_t j = i + 1; j < vs.size(); ++j) {
                    adj[vs[i]].insert(vs[j]);
                    adj[vs[j]].insert(vs[i]);
                }
        }
    }
    std::vector<std::vector<int32_t>> out(n);
    for (size_t i = 0; i < n; ++i) {
        out[i].assign(adj[i].begin(), adj[i].end());
        std::sort(out[i].begin(), out[i].end());
    }
    return out;
}

// double-sweep pseudo-peripheral node of start's unvisited component
// (ref: include/pseudo_peripheral_node.hxx:60-100; the reference's
// farthest_node returns its argument — bug — fixed here; smallest-index
// tie-break at max distance, matching ILPInput._pseudo_peripheral_start)
inline int32_t pseudo_peripheral_start(
    const std::vector<std::vector<int32_t>>& adj,
    const std::vector<char>& visited, int32_t start) {
    std::vector<int32_t> dist(adj.size());
    auto farthest = [&](int32_t x) -> std::pair<int32_t, int32_t> {
        std::fill(dist.begin(), dist.end(), -1);
        dist[x] = 0;
        std::deque<int32_t> q{x};
        int32_t best = x, best_d = 0;
        while (!q.empty()) {
            int32_t u = q.front();
            q.pop_front();
            for (int32_t v : adj[u])
                if (!visited[v] && dist[v] < 0) {
                    dist[v] = dist[u] + 1;
                    if (dist[v] > best_d || (dist[v] == best_d && v < best)) {
                        best = v;
                        best_d = dist[v];
                    }
                    q.push_back(v);
                }
        }
        return {best, best_d};
    };
    auto [y, d_y] = farthest(start);
    auto [z, d_z] = farthest(y);
    while (d_z > d_y) {
        y = z;
        d_y = d_z;
        std::tie(z, d_z) = farthest(y);
    }
    return y;
}

// BFS / Cuthill-McKee variable ordering (semantics of ILPInput._bfs_order;
// Cuthill uses pseudo-peripheral starts per component like the reference)
inline std::vector<int32_t> bfs_order(const Ilp& ilp, bool by_degree,
                                      bool pseudo_peripheral = false) {
    auto adj = adjacency(ilp);
    size_t n = adj.size();
    std::vector<int32_t> deg(n);
    for (size_t i = 0; i < n; ++i) deg[i] = (int32_t)adj[i].size();
    std::vector<int32_t> start(n);
    std::iota(start.begin(), start.end(), 0);
    std::stable_sort(start.begin(), start.end(),
                     [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
    std::vector<char> visited(n, 0);
    std::vector<int32_t> order;
    order.reserve(n);
    std::deque<int32_t> q;
    for (int32_t s : start) {
        if (visited[s]) continue;
        if (pseudo_peripheral) s = pseudo_peripheral_start(adj, visited, s);
        visited[s] = 1;
        q.push_back(s);
        while (!q.empty()) {
            int32_t u = q.front();
            q.pop_front();
            order.push_back(u);
            std::vector<int32_t> nbrs;
            for (int32_t v : adj[u])
                if (!visited[v]) nbrs.push_back(v);
            if (by_degree)
                std::stable_sort(nbrs.begin(), nbrs.end(),
                                 [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
            for (int32_t v : nbrs) {
                visited[v] = 1;
                q.push_back(v);
            }
        }
    }
    return order;
}

// greedy minimum-degree ordering with lazy degree recomputation (semantics
// of ILPInput.reorder_minimum_degree: degree among alive nodes, ties by
// index ascending)
inline std::vector<int32_t> min_degree_order(const Ilp& ilp) {
    auto adj = adjacency(ilp);
    size_t n = adj.size();
    std::vector<char> alive(n, 1);
    auto alive_deg = [&](int32_t v) {
        int32_t d = 0;
        for (int32_t u : adj[v]) d += alive[u];
        return d;
    };
    using Item = std::pair<int32_t, int32_t>;  // (degree, node)
    std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
    for (size_t v = 0; v < n; ++v)
        heap.push({(int32_t)adj[v].size(), (int32_t)v});
    std::vector<int32_t> order;
    order.reserve(n);
    while (!heap.empty()) {
        auto [d, v] = heap.top();
        heap.pop();
        if (!alive[v]) continue;
        int32_t cur = alive_deg(v);
        if (d != cur) {
            heap.push({cur, v});
            continue;
        }
        alive[v] = 0;
        order.push_back(v);
    }
    return order;
}

inline void apply_order(Ilp& ilp, const std::vector<int32_t>& order) {
    size_t n = ilp.var_names.size();
    std::vector<int32_t> new_of_old(n);
    for (size_t i = 0; i < n; ++i) new_of_old[order[i]] = (int32_t)i;
    std::vector<std::string> names(n);
    std::vector<double> obj(n);
    for (size_t i = 0; i < n; ++i) {
        names[i] = ilp.var_names[order[i]];
        obj[i] = ilp.objective[order[i]];
    }
    ilp.var_names = std::move(names);
    ilp.objective = std::move(obj);
    ilp.var_index.clear();
    for (size_t i = 0; i < n; ++i) ilp.var_index.emplace(ilp.var_names[i], (int32_t)i);
    for (auto& c : ilp.constraints) {
        for (auto& v : c.vars) v = new_of_old[v];
        for (auto& m : c.monos)
            for (auto& v : m) v = new_of_old[v];
    }
    normalize(ilp);
}

// ------------------------------------------------------------ BDD construction
// Terminals as negative ids (TOP=-1, BOT=-2), matching the python collection.
constexpr int64_t TOPv = -1;
constexpr int64_t BOTv = -2;

struct BddNodes {
    // per node: level (index into support), lo, hi (node index or terminal)
    std::vector<int32_t> level;
    std::vector<int64_t> lo, hi;
    std::vector<int32_t> support;  // variable per level
};

// inequality -> reduced OBDD via two-pass layered DP (lineq.py semantics;
// canonical result of Behle interval dedup, ref lineq_bdd.cpp:7-171).
// Returns 1 (bdd built), 0 (always true), -1 (always false).
inline int build_inequality_bdd(const Constraint& cin, BddNodes& out) {
    std::vector<int64_t> coeffs(cin.coeffs.begin(), cin.coeffs.end());
    int64_t rhs = cin.rhs;
    Ineq ineq = cin.ineq;
    size_t n = coeffs.size();
    if (ineq == Ineq::GEQ) {
        for (auto& c : coeffs) c = -c;
        rhs = -rhs;
        ineq = Ineq::LEQ;
    }
    std::vector<char> flip(n, 0);
    for (size_t i = 0; i < n; ++i)
        if (coeffs[i] < 0) {
            flip[i] = 1;
            rhs -= coeffs[i];
            coeffs[i] = -coeffs[i];
        }
    // gcd
    int64_t g = 0;
    for (auto c : coeffs) g = std::gcd(g, c);
    if (g > 1) {
        if (ineq == Ineq::LEQ) {
            rhs = (rhs >= 0) ? rhs / g : -((-rhs + g - 1) / g);  // floor div
        } else {
            if (rhs % g != 0) return -1;
            rhs /= g;
        }
        for (auto& c : coeffs) c /= g;
    }
    std::vector<int64_t> max_suffix(n + 1, 0);
    for (size_t i = n; i-- > 0;) max_suffix[i] = max_suffix[i + 1] + coeffs[i];

    // clamp: returns 0 normal (state in *state), 1 TOP, -1 BOT
    auto clamp = [&](size_t i, int64_t b, int64_t* state) -> int {
        if (ineq == Ineq::LEQ) {
            if (b < 0) return -1;
            if (b >= max_suffix[i]) return 1;
        } else {
            if (b < 0 || b > max_suffix[i]) return -1;
            if (i == n) return 1;  // b == 0 by the bounds above
        }
        *state = b;
        return 0;
    };

    int64_t s0;
    int c0 = clamp(0, rhs, &s0);
    if (c0 == 1) return 0;
    if (c0 == -1) return -1;

    // pass 1: reachable budgets (sorted sets per level)
    std::vector<std::vector<int64_t>> levels(n + 1);
    levels[0].push_back(s0);
    for (size_t i = 0; i < n; ++i) {
        std::vector<int64_t> nxt;
        nxt.reserve(levels[i].size() * 2);
        for (int64_t b : levels[i]) {
            int64_t st;
            if (clamp(i + 1, b, &st) == 0) nxt.push_back(st);
            if (clamp(i + 1, b - coeffs[i], &st) == 0) nxt.push_back(st);
        }
        std::sort(nxt.begin(), nxt.end());
        nxt.erase(std::unique(nxt.begin(), nxt.end()), nxt.end());
        levels[i + 1] = std::move(nxt);
    }

    // pass 2: bottom-up merge by (lo, hi) signature
    std::vector<int32_t> node_level;
    std::vector<int64_t> node_lo, node_hi;
    std::vector<std::unordered_map<int64_t, int64_t>> node_of(n + 1);
    auto resolve = [&](size_t i, int64_t b) -> int64_t {
        int64_t st;
        int c = clamp(i, b, &st);
        if (c == 1) return TOPv;
        if (c == -1) return BOTv;
        return node_of[i][st];
    };
    for (size_t i = n; i-- > 0;) {
        std::map<std::pair<int64_t, int64_t>, int64_t> sig;
        for (int64_t b : levels[i]) {
            int64_t lo = resolve(i + 1, b);
            int64_t hi = resolve(i + 1, b - coeffs[i]);
            if (lo == hi) {
                node_of[i][b] = lo;
                continue;
            }
            auto key = std::make_pair(lo, hi);
            auto it = sig.find(key);
            if (it == sig.end()) {
                node_level.push_back((int32_t)i);
                node_lo.push_back(lo);
                node_hi.push_back(hi);
                it = sig.emplace(key, (int64_t)node_level.size() - 1).first;
            }
            node_of[i][b] = it->second;
        }
    }
    int64_t root = node_of[0].count(s0) ? node_of[0][s0] : resolve(0, rhs);
    if (root == TOPv) return 0;
    if (root == BOTv) return -1;

    // apply flips
    for (size_t k = 0; k < node_level.size(); ++k)
        if (flip[node_level[k]]) std::swap(node_lo[k], node_hi[k]);

    // topological order: sort by (level, creation) with root first; creation
    // order within a level is already consistent
    size_t m = node_level.size();
    std::vector<int64_t> order(m);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return node_level[a] < node_level[b];
    });
    if (order[0] != root) {
        auto it = std::find(order.begin(), order.end(), root);
        order.erase(it);
        order.insert(order.begin(), root);
    }
    std::vector<int64_t> newid(m);
    for (size_t k = 0; k < m; ++k) newid[order[k]] = (int64_t)k;
    out.level.resize(m);
    out.lo.resize(m);
    out.hi.resize(m);
    for (size_t k = 0; k < m; ++k) {
        int64_t o = order[k];
        out.level[k] = node_level[o];
        out.lo[k] = node_lo[o] < 0 ? node_lo[o] : newid[node_lo[o]];
        out.hi[k] = node_hi[o] < 0 ? node_hi[o] : newid[node_hi[o]];
    }
    // support: variables at used levels (after reduction some levels may be
    // skipped by all nodes — they still appear via qbdd chains only if used
    // between root and leaves; match python: support = levels of used vars)
    out.support.assign(cin.vars.begin(), cin.vars.end());
    return 1;
}

// product (meld) of k reduced BDDs over the union of their supports —
// coalesce groups (semantics of collection.bdd_and / ref bdd_collection
// multi-way meld, bdd_collection.h:495-600, different construction: operand-
// node-tuple BFS per union level + bottom-up signature merge, reusing the
// two-pass canonicalization of build_inequality_bdd).
// Returns 1 (bdd in out), 0 (always true), -1 (empty product).
inline int meld_product(const std::vector<const BddNodes*>& ops, BddNodes& out) {
    const size_t K = ops.size();
    // union support (operand supports are sorted ascending)
    std::vector<int32_t> support;
    {
        std::vector<int32_t> all;
        for (auto* o : ops)
            all.insert(all.end(), o->support.begin(), o->support.end());
        std::sort(all.begin(), all.end());
        all.erase(std::unique(all.begin(), all.end()), all.end());
        support = std::move(all);
    }
    const size_t D = support.size();
    // per-operand: local level of union level k (-1 when absent)
    std::vector<std::vector<int32_t>> pos(K, std::vector<int32_t>(D, -1));
    for (size_t i = 0; i < K; ++i) {
        size_t j = 0;
        for (size_t k = 0; k < D; ++k)
            if (j < ops[i]->support.size() && ops[i]->support[j] == support[k])
                pos[i][k] = (int32_t)j++;
    }

    using Tuple = std::vector<int64_t>;
    // normalize: any BOT -> BOT; all TOP -> TOP; else keep
    auto classify = [&](const Tuple& t) -> int64_t {
        bool all_top = true;
        for (int64_t x : t) {
            if (x == BOTv) return BOTv;
            if (x != TOPv) all_top = false;
        }
        return all_top ? TOPv : 0;
    };
    auto advance = [&](const Tuple& t, size_t k, bool hi) {
        Tuple n(t);
        for (size_t i = 0; i < K; ++i) {
            int64_t x = t[i];
            if (x >= 0 && pos[i][k] >= 0 && ops[i]->level[(size_t)x] == pos[i][k])
                n[i] = hi ? ops[i]->hi[(size_t)x] : ops[i]->lo[(size_t)x];
        }
        return n;
    };

    Tuple root(K, 0);
    if (int64_t c = classify(root); c != 0) return c == TOPv ? 0 : -1;

    // pass 1: reachable tuples per level
    std::vector<std::map<Tuple, int64_t>> states(D + 1);
    states[0].emplace(root, -3);  // value filled in pass 2
    size_t total = 1;
    for (size_t k = 0; k < D; ++k) {
        for (auto& [t, _] : states[k]) {
            for (bool hi : {false, true}) {
                Tuple n = advance(t, k, hi);
                if (classify(n) != 0) continue;
                if (states[k + 1].emplace(std::move(n), -3).second &&
                    ++total > (size_t)1 << 22)
                    throw std::runtime_error("meld: state explosion");
            }
        }
    }

    // pass 2: bottom-up with (lo, hi) signature merge per level
    std::vector<int32_t> node_level;
    std::vector<int64_t> node_lo, node_hi;
    auto resolve = [&](size_t k, const Tuple& t) -> int64_t {
        int64_t c = classify(t);
        if (c != 0) return c;
        return states[k].at(t);
    };
    for (size_t k = D; k-- > 0;) {
        std::map<std::pair<int64_t, int64_t>, int64_t> sig;
        for (auto& [t, val] : states[k]) {
            int64_t lo = resolve(k + 1, advance(t, k, false));
            int64_t hi = resolve(k + 1, advance(t, k, true));
            if (lo == hi) {
                val = lo;
                continue;
            }
            auto key = std::make_pair(lo, hi);
            auto it = sig.find(key);
            if (it == sig.end()) {
                node_level.push_back((int32_t)k);
                node_lo.push_back(lo);
                node_hi.push_back(hi);
                it = sig.emplace(key, (int64_t)node_level.size() - 1).first;
            }
            val = it->second;
        }
    }
    int64_t root_id = states[0].at(root);
    if (root_id == TOPv) return 0;
    if (root_id == BOTv) return -1;

    // topological order, root first (same post-processing as
    // build_inequality_bdd)
    size_t m = node_level.size();
    std::vector<int64_t> order(m);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return node_level[a] < node_level[b];
    });
    if (order[0] != root_id) {
        auto it = std::find(order.begin(), order.end(), root_id);
        order.erase(it);
        order.insert(order.begin(), root_id);
    }
    std::vector<int64_t> newid(m);
    for (size_t k2 = 0; k2 < m; ++k2) newid[order[k2]] = (int64_t)k2;
    out.level.resize(m);
    out.lo.resize(m);
    out.hi.resize(m);
    for (size_t k2 = 0; k2 < m; ++k2) {
        int64_t o = order[k2];
        out.level[k2] = node_level[o];
        out.lo[k2] = node_lo[o] < 0 ? node_lo[o] : newid[node_lo[o]];
        out.hi[k2] = node_hi[o] < 0 ? node_hi[o] : newid[node_hi[o]];
    }
    out.support = support;
    return 1;
}

// quasi-reduction over the *used* support (collection.make_qbdd semantics):
// re-levels to the compact support of variables actually appearing, chains
// skipped levels and TOP arcs, leaves BOT arcs direct.
struct QbddOut {
    // nodes with level = position in compact support; root at index 0
    std::vector<int32_t> level;
    std::vector<int64_t> lo, hi;
    std::vector<int32_t> vars;  // compact support (global var ids), path order
};

inline void make_qbdd(const BddNodes& in, QbddOut& out) {
    // compact support: levels used by at least one node
    std::vector<int32_t> used_levels;
    {
        std::vector<char> used(in.support.size(), 0);
        for (int32_t l : in.level) used[l] = 1;
        for (size_t l = 0; l < used.size(); ++l)
            if (used[l]) used_levels.push_back((int32_t)l);
    }
    std::vector<int32_t> pos_of_level(in.support.size(), -1);
    for (size_t k = 0; k < used_levels.size(); ++k) pos_of_level[used_levels[k]] = (int32_t)k;
    size_t d = used_levels.size();
    out.vars.resize(d);
    for (size_t k = 0; k < d; ++k) out.vars[k] = in.support[used_levels[k]];

    size_t base = in.level.size();
    std::vector<int32_t> level(in.level.size());
    for (size_t i = 0; i < in.level.size(); ++i) level[i] = pos_of_level[in.level[i]];
    std::vector<int64_t> lo(in.lo), hi(in.hi);

    std::map<std::pair<int32_t, int64_t>, int64_t> chain_memo;
    std::vector<int32_t> xlevel;  // extra chain nodes
    std::vector<int64_t> xlo, xhi;

    // mkchain(p, target at tpos): don't-care nodes covering p..tpos-1
    std::function<int64_t(int32_t, int64_t, int32_t)> mkchain =
        [&](int32_t p, int64_t target, int32_t tpos) -> int64_t {
        if (p == tpos) return target;
        auto key = std::make_pair(p, target);
        auto it = chain_memo.find(key);
        if (it != chain_memo.end()) return it->second;
        int64_t child = mkchain(p + 1, target, tpos);
        xlevel.push_back(p);
        xlo.push_back(child);
        xhi.push_back(child);
        int64_t id = (int64_t)(base + xlevel.size() - 1);
        chain_memo.emplace(key, id);
        return id;
    };
    auto tpos_of = [&](int64_t c) -> int32_t {
        if (c == TOPv) return (int32_t)d;
        return level[(size_t)c];
    };
    auto route = [&](int32_t p_from, int64_t c) -> int64_t {
        if (c == BOTv) return BOTv;
        return mkchain(p_from + 1, c, tpos_of(c));
    };
    size_t n0 = level.size();
    for (size_t i = 0; i < n0; ++i) {
        int32_t p = level[i];
        lo[i] = route(p, lo[i]);
        hi[i] = route(p, hi[i]);
    }
    // merge node arrays (extra nodes reference base+j ids and original ids)
    std::vector<int32_t> mlevel(level);
    std::vector<int64_t> mlo(lo), mhi(hi);
    for (size_t j = 0; j < xlevel.size(); ++j) {
        mlevel.push_back(xlevel[j]);
        mlo.push_back(xlo[j]);
        mhi.push_back(xhi[j]);
    }
    // topological order (children after parents): stable sort by level; the
    // root is the unique minimal-level node
    size_t m = mlevel.size();
    std::vector<int64_t> order(m);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return mlevel[a] < mlevel[b]; });
    std::vector<int64_t> newid(m);
    for (size_t k = 0; k < m; ++k) newid[order[k]] = (int64_t)k;
    out.level.resize(m);
    out.lo.resize(m);
    out.hi.resize(m);
    for (size_t k = 0; k < m; ++k) {
        int64_t o = order[k];
        out.level[k] = mlevel[o];
        out.lo[k] = mlo[o] < 0 ? mlo[o] : newid[mlo[o]];
        out.hi[k] = mhi[o] < 0 ? mhi[o] : newid[mhi[o]];
    }
}

// --------------------------------------------------------------- collection
struct Collection {
    // per bdd: compact nodes with (level, lo, hi) local ids + support vars
    std::vector<QbddOut> bdds;
};

// ------------------------------------------------------------------ buckets
struct Bucket {
    int32_t P = 0, H = 0, B = 0;  // padded dims
    int32_t nB = 0;               // real bdd count
    // arrays sized [H][P][B] flattened C-order
    std::vector<int8_t> node_valid, lo_kind, hi_kind;
    std::vector<int32_t> lo_slot, hi_slot;
    std::vector<int8_t> layer_valid;  // [H][B]
    std::vector<int32_t> layer_var;   // [H][B]
    std::vector<int64_t> bdd_of_col;  // [B]
    std::vector<int32_t> depths;      // [B]
};

inline int32_t pow2ceil(int32_t x) {
    int32_t p = 1;
    while (p < x) p *= 2;
    return p;
}

struct Context {
    Ilp ilp;
    Collection col;
    std::vector<Bucket> buckets;
    std::string err;
    bool infeasible = false;
    std::vector<int32_t> last_order;  // old index per new position (reorder)

    bool build() {
        normalize(ilp);
        linearize_nonlinear(ilp);
        normalize(ilp);
        for (auto& c : ilp.constraints) {
            int64_t mx = 0;
            for (int64_t x : c.coeffs) mx = std::max(mx, std::abs(x));
            if (mx > ((int64_t)1 << 20) && c.vars.size() > 64)
                throw std::runtime_error(
                    "huge coefficients (python coefficient decomposition "
                    "fallback required)");
        }
        if (!preprocess(ilp)) {
            infeasible = true;
            return false;
        }
        std::vector<char> covered(ilp.var_names.size(), 0);
        // parallel per-constraint BDD construction, ordered assembly
        // (ref: OpenMP ordered loop, bdd_preprocessor.cpp:146-359)
        const size_t nc = ilp.constraints.size();
        std::vector<int32_t> in_group(nc, -1);
        for (size_t gi = 0; gi < ilp.coalesce_sets.size(); ++gi)
            for (int32_t ci : ilp.coalesce_sets[gi]) in_group[ci] = (int32_t)gi;
        std::vector<QbddOut> results(nc);
        std::vector<BddNodes> raws(nc);  // kept only for coalesce members
        std::vector<int8_t> status(nc, 0);
        std::atomic<bool> thrown{false};
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
        for (size_t ci = 0; ci < nc; ++ci) {
            // an exception escaping an OpenMP region calls std::terminate,
            // bypassing bh_build's try/catch and the python fallback —
            // capture it and re-raise after the join instead
            try {
                BddNodes raw;
                int r = build_inequality_bdd(ilp.constraints[ci], raw);
                status[ci] = (int8_t)r;
                if (r == 1) {
                    if (in_group[ci] >= 0)
                        raws[ci] = std::move(raw);
                    else
                        make_qbdd(raw, results[ci]);
                }
            } catch (...) {
                thrown.store(true);
            }
        }
        if (thrown.load())
            throw std::runtime_error(
                "exception during parallel BDD construction");
        for (size_t ci = 0; ci < nc; ++ci)
            if (status[ci] == -1) {
                infeasible = true;
                return false;
            }
        // meld coalesce groups into one BDD each (emitted at the first
        // contributing member's position; bdd/preprocessor.py:73-106)
        std::vector<QbddOut> group_bdd(ilp.coalesce_sets.size());
        std::vector<int8_t> group_status(ilp.coalesce_sets.size(), 0);
        for (size_t gi = 0; gi < ilp.coalesce_sets.size(); ++gi) {
            std::vector<const BddNodes*> members;
            for (int32_t ci : ilp.coalesce_sets[gi])
                if (status[ci] == 1) members.push_back(&raws[ci]);
            if (members.empty()) continue;
            BddNodes melded;
            int r = meld_product(members, melded);
            if (r == -1) {
                infeasible = true;
                return false;
            }
            group_status[gi] = (int8_t)r;
            if (r == 1) make_qbdd(melded, group_bdd[gi]);
        }
        std::vector<char> group_emitted(ilp.coalesce_sets.size(), 0);
        for (size_t ci = 0; ci < nc; ++ci) {
            const int32_t gi = in_group[ci];
            if (gi < 0) {
                if (status[ci] == 0) continue;
                for (int32_t v : results[ci].vars) covered[v] = 1;
                col.bdds.push_back(std::move(results[ci]));
            } else if (!group_emitted[gi] && group_status[gi] == 1) {
                group_emitted[gi] = 1;
                for (int32_t v : group_bdd[gi].vars) covered[v] = 1;
                col.bdds.push_back(std::move(group_bdd[gi]));
            }
        }
        // free-variable BDDs for uncovered vars with nonzero objective
        for (size_t v = 0; v < covered.size(); ++v) {
            if (!covered[v] && ilp.objective[v] != 0.0) {
                QbddOut q;
                q.level = {0};
                q.lo = {TOPv};
                q.hi = {TOPv};
                q.vars = {(int32_t)v};
                col.bdds.push_back(std::move(q));
            }
        }
        build_buckets();
        return true;
    }

    void build_buckets() {
        const int32_t ARC_INTERNAL = 0, ARC_TOP = 1, ARC_BOT = 2;
        // group by (P, H) buckets
        struct Member {
            size_t bdd;
            int32_t depth, width;
            std::vector<int32_t> slots;
        };
        std::map<std::pair<int32_t, int32_t>, std::vector<Member>> groups;
        for (size_t b = 0; b < col.bdds.size(); ++b) {
            auto& q = col.bdds[b];
            int32_t depth = (int32_t)q.vars.size();
            std::vector<int32_t> cnt(depth, 0);
            std::vector<int32_t> slots(q.level.size());
            for (size_t i = 0; i < q.level.size(); ++i)
                slots[i] = cnt[q.level[i]]++;
            int32_t width = *std::max_element(cnt.begin(), cnt.end());
            // depth rounded to eighth-of-pow2 steps: <=12.5% hop padding and
            // a bounded bucket count (vs pow2 rounding which wasted up to 2x
            // of the exchange + sweep volume, e.g. depth-9 BDDs in H=16)
            int32_t step = std::max(1, pow2ceil(depth) / 8);
            int32_t hkey = ((depth + step - 1) / step) * step;
            groups[{pow2ceil(width), hkey}].push_back(
                {b, depth, width, std::move(slots)});
        }
        // coalesce small same-width depth groups upward: a group with
        // H * members below the work threshold costs more in per-kernel
        // overhead than its padding saves (mirrors uniform._merge_small_buckets)
        const int64_t MERGE_WORK = 8192;
        {
            std::map<std::pair<int32_t, int32_t>, std::vector<Member>> merged;
            // std::map iterates keys sorted by (P, H) already
            for (auto it = groups.begin(); it != groups.end();) {
                int32_t P = it->first.first;
                std::vector<std::pair<int32_t, std::vector<Member>*>> hs;
                auto jt = it;
                for (; jt != groups.end() && jt->first.first == P; ++jt)
                    hs.push_back({jt->first.second, &jt->second});
                std::vector<Member> carry;
                for (size_t i = 0; i < hs.size(); ++i) {
                    std::vector<Member> mem = std::move(carry);
                    carry.clear();
                    mem.insert(mem.end(),
                               std::make_move_iterator(hs[i].second->begin()),
                               std::make_move_iterator(hs[i].second->end()));
                    if (i + 1 < hs.size() &&
                        (int64_t)mem.size() * hs[i].first < MERGE_WORK) {
                        carry = std::move(mem);
                    } else {
                        merged[{P, hs[i].first}] = std::move(mem);
                    }
                }
                it = jt;
            }
            groups = std::move(merged);
        }
        buckets.clear();
        for (auto& [key, members] : groups) {
            Bucket bk;
            bk.P = key.first;
            bk.H = key.second;
            bk.nB = (int32_t)members.size();
            // TPU lanes (the JAX package's layout), but none for a huge
            // bucket (P > 8,192): its sweep body runs a block a column
            int32_t pad = bk.P > 8192 ? 1 : (bk.nB >= 128 ? 128 : 8);
            bk.B = ((bk.nB + pad - 1) / pad) * pad;
            size_t npb = (size_t)bk.H * bk.P * bk.B;
            bk.node_valid.assign(npb, 0);
            bk.lo_kind.assign(npb, ARC_BOT);
            bk.lo_slot.assign(npb, 0);
            bk.hi_kind.assign(npb, ARC_BOT);
            bk.hi_slot.assign(npb, 0);
            bk.layer_valid.assign((size_t)bk.H * bk.B, 0);
            bk.layer_var.assign((size_t)bk.H * bk.B,
                                (int32_t)ilp.var_names.size());
            bk.bdd_of_col.assign(bk.B, -1);
            bk.depths.assign(bk.B, 0);
            auto nidx = [&](int32_t h, int32_t p, int32_t c) {
                return ((size_t)h * bk.P + p) * bk.B + c;
            };
            auto lidx = [&](int32_t h, int32_t c) { return (size_t)h * bk.B + c; };
            for (int32_t cI = 0; cI < bk.nB; ++cI) {
                auto& m = members[cI];
                auto& q = col.bdds[m.bdd];
                bk.bdd_of_col[cI] = (int64_t)m.bdd;
                bk.depths[cI] = m.depth;
                for (int32_t h = 0; h < m.depth; ++h) {
                    bk.layer_valid[lidx(h, cI)] = 1;
                    bk.layer_var[lidx(h, cI)] = q.vars[h];
                }
                for (size_t i = 0; i < q.level.size(); ++i) {
                    int32_t h = q.level[i], p = m.slots[i];
                    bk.node_valid[nidx(h, p, cI)] = 1;
                    int64_t lo = q.lo[i], hi = q.hi[i];
                    if (lo == TOPv)
                        bk.lo_kind[nidx(h, p, cI)] = ARC_TOP;
                    else if (lo == BOTv)
                        bk.lo_kind[nidx(h, p, cI)] = ARC_BOT;
                    else {
                        bk.lo_kind[nidx(h, p, cI)] = ARC_INTERNAL;
                        bk.lo_slot[nidx(h, p, cI)] = m.slots[(size_t)lo];
                    }
                    if (hi == TOPv)
                        bk.hi_kind[nidx(h, p, cI)] = ARC_TOP;
                    else if (hi == BOTv)
                        bk.hi_kind[nidx(h, p, cI)] = ARC_BOT;
                    else {
                        bk.hi_kind[nidx(h, p, cI)] = ARC_INTERNAL;
                        bk.hi_slot[nidx(h, p, cI)] = m.slots[(size_t)hi];
                    }
                }
            }
            buckets.push_back(std::move(bk));
        }
    }
};

// ----------------------------------------------------- CPU parallel MMA
// Honest multi-core CPU baseline: the FastDOG deferred min-marginal-averaging
// iteration (semantics of the reference's OpenMP parallel solver,
// src/bdd_solver/bdd_parallel_mma_base.cpp:815-1044, and bit-compatible with
// our numpy oracle solver/ref_solver.py) with OpenMP parallelism over BDDs.
// The per-variable delta is computed between half-sweeps from the stored
// deferred mm differences (deterministic; replaces the reference's CAS float
// atomics — same dual trajectory, no ordering hazards).
struct CpuSolver {
    // geometry (BDD-major, level-contiguous nodes)
    int64_t nr_bdds = 0, nr_vars = 0, nr_nodes = 0, nr_layers = 0;
    std::vector<int64_t> node_off;    // per bdd, nodes start (size nr_bdds+1)
    std::vector<int64_t> layer_off;   // per bdd, layers start (size nr_bdds+1)
    std::vector<int64_t> level_off;   // per layer, node range start; size
                                      // nr_layers + nr_bdds (one sentinel per bdd)
    std::vector<int64_t> lvl_idx;     // per bdd, index of its level_off base
    std::vector<int64_t> lo_arc, hi_arc;  // per node: global node id or TOPv/BOTv
    std::vector<int32_t> layer_var;       // per layer: global variable
    std::vector<int32_t> nbpv;            // num bdds per var

    // state
    std::vector<double> lo_cost, hi_cost, def_mm;  // per layer
    std::vector<double> cfr, cft;                  // per node
    std::vector<double> mm_scratch;                // min_marginals fwd scratch
    bool cft_valid = false;

    // scratch
    int n_threads = 1;
    std::vector<std::vector<double>> tl_dlo, tl_dhi;  // per-thread deltas
    std::vector<double> delta_lo, delta_hi;

    static double term_cft(int64_t a, const double* cft) {
        if (a == TOPv) return 0.0;
        if (a == BOTv) return std::numeric_limits<double>::infinity();
        return cft[a];
    }

    void build(const Collection& col, int64_t nvars, const double* obj,
               const int32_t* nbpv_override = nullptr) {
        nr_bdds = (int64_t)col.bdds.size();
        nr_vars = nvars;
        node_off.assign(nr_bdds + 1, 0);
        layer_off.assign(nr_bdds + 1, 0);
        lvl_idx.assign(nr_bdds, 0);
        int64_t lvl_total = 0;
        for (int64_t b = 0; b < nr_bdds; ++b) {
            node_off[b + 1] = node_off[b] + (int64_t)col.bdds[b].level.size();
            layer_off[b + 1] = layer_off[b] + (int64_t)col.bdds[b].vars.size();
            lvl_idx[b] = lvl_total;
            lvl_total += (int64_t)col.bdds[b].vars.size() + 1;
        }
        nr_nodes = node_off[nr_bdds];
        nr_layers = layer_off[nr_bdds];
        lo_arc.resize(nr_nodes);
        hi_arc.resize(nr_nodes);
        layer_var.resize(nr_layers);
        level_off.assign(lvl_total, 0);
        nbpv.assign(nr_vars, 0);
        for (int64_t b = 0; b < nr_bdds; ++b) {
            const auto& q = col.bdds[b];
            const int64_t nb = node_off[b];
            const int64_t d = (int64_t)q.vars.size();
            // nodes are level-sorted (make_qbdd stable sort); count per level
            int64_t* lo_ = &level_off[lvl_idx[b]];
            for (size_t i = 0; i < q.level.size(); ++i) lo_[q.level[i] + 1]++;
            for (int64_t h = 0; h < d; ++h) lo_[h + 1] += lo_[h];
            for (int64_t h = 0; h <= d; ++h) lo_[h] += nb;
            for (size_t i = 0; i < q.level.size(); ++i) {
                lo_arc[nb + i] = q.lo[i] < 0 ? q.lo[i] : nb + q.lo[i];
                hi_arc[nb + i] = q.hi[i] < 0 ? q.hi[i] : nb + q.hi[i];
            }
            for (int64_t h = 0; h < d; ++h) {
                layer_var[layer_off[b] + h] = q.vars[h];
                nbpv[q.vars[h]]++;
            }
        }
        // hybrid host+device split (ref bdd_multi_parallel_mma_base.cu:
        // total_nr_bdds_per_var_): this solver owns only a SUBSET of the
        // BDDs but must average with the GLOBAL per-variable counts so the
        // joint trajectory equals the monolithic one
        if (nbpv_override)
            std::copy(nbpv_override, nbpv_override + nr_vars, nbpv.begin());
        lo_cost.assign(nr_layers, 0.0);
        hi_cost.assign(nr_layers, 0.0);
        def_mm.assign(nr_layers, 0.0);
        for (int64_t l = 0; l < nr_layers; ++l)
            hi_cost[l] = obj[layer_var[l]] / (double)nbpv[layer_var[l]];
        cfr.assign(nr_nodes, 0.0);
        cft.assign(nr_nodes, 0.0);
        // per-thread delta scratch: sized in compute_delta by the calling
        // thread's team bound, which may exceed the creating thread's
        tl_dlo.clear();
        tl_dhi.clear();
#ifdef _OPENMP
        n_threads = omp_get_max_threads();  // reported until the first team runs
#endif
        delta_lo.assign(nr_vars, 0.0);
        delta_hi.assign(nr_vars, 0.0);
    }

    // delta[v] = sum_layers relu(-+def_mm) (ref_solver._compute_delta).
    // Deterministic for a given team size: a static schedule gives each
    // thread the same layers on every call, and the rows of the team are
    // added in thread order. A team of another size sums in another order
    // (the last bit may differ between OMP_NUM_THREADS settings).
    void compute_delta() {
        // A parallel region started here has at most omp_get_max_threads()
        // threads of THIS thread (an OpenMP per-thread setting), so the
        // scratch grows to that bound before the region; the team's real
        // size nt is read inside it, and only rows below nt are summed
        // (rows of threads outside the team may hold an older call's sums).
        int bound = 1;
#ifdef _OPENMP
        bound = omp_get_max_threads();
#endif
        if ((int)tl_dlo.size() < bound) {
            tl_dlo.resize(bound, std::vector<double>(nr_vars, 0.0));
            tl_dhi.resize(bound, std::vector<double>(nr_vars, 0.0));
        }
#ifdef _OPENMP
#pragma omp parallel
#endif
        {
            int t = 0, nt = 1;
#ifdef _OPENMP
            t = omp_get_thread_num();
            nt = omp_get_num_threads();
#endif
            if (t == 0) n_threads = nt;
            double* dlo = tl_dlo[t].data();
            double* dhi = tl_dhi[t].data();
            std::fill(tl_dlo[t].begin(), tl_dlo[t].end(), 0.0);
            std::fill(tl_dhi[t].begin(), tl_dhi[t].end(), 0.0);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
            for (int64_t l = 0; l < nr_layers; ++l) {
                const double mm = def_mm[l];
                const int32_t v = layer_var[l];
                dlo[v] += std::max(-mm, 0.0);
                dhi[v] += std::max(mm, 0.0);
            }
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
            for (int64_t v = 0; v < nr_vars; ++v) {
                double slo = 0.0, shi = 0.0;
                for (int tt = 0; tt < nt; ++tt) {
                    slo += tl_dlo[tt][v];
                    shi += tl_dhi[tt][v];
                }
                delta_lo[v] = slo;
                delta_hi[v] = shi;
            }
        }
    }

    // shared per-layer MMA cost update (ref_solver._hop_cost_update)
    static inline void layer_update(double m0, double m1, double omega,
                                    double alpha, double din_lo, double din_hi,
                                    double& lo, double& hi, double& mm_out) {
        const double INFD = std::numeric_limits<double>::infinity();
        const bool f0 = std::isfinite(m0), f1 = std::isfinite(m1);
        if (f0 && f1) {
            const double mm_rm = omega * (m1 - m0);
            lo = lo - std::max(-mm_rm, 0.0) + alpha * din_lo;
            hi = hi - std::max(mm_rm, 0.0) + alpha * din_hi;
            mm_out = mm_rm;
        } else {
            lo = (f0 ? lo : INFD) + alpha * din_lo;
            hi = (f1 ? hi : INFD) + alpha * din_hi;
            mm_out = f1 ? -INFD : INFD;
        }
    }

    void backward_run() {  // plain shortest-path to TOP with current costs
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
        for (int64_t b = 0; b < nr_bdds; ++b) {
            const int64_t* lvl = &level_off[lvl_idx[b]];
            const int64_t d = layer_off[b + 1] - layer_off[b];
            for (int64_t h = d; h-- > 0;) {
                const double cl = lo_cost[layer_off[b] + h];
                const double ch = hi_cost[layer_off[b] + h];
                for (int64_t i = lvl[h]; i < lvl[h + 1]; ++i)
                    cft[i] = std::min(term_cft(lo_arc[i], cft.data()) + cl,
                                      term_cft(hi_arc[i], cft.data()) + ch);
            }
        }
        cft_valid = true;
    }

    // one forward (dir=+1) or backward (dir=-1) half-iteration
    void half_iteration(double omega, int dir) {
        compute_delta();
        half_sweep(omega, dir);
    }

    // hybrid host+device consensus hooks (ref bdd_multi_parallel_mma_base
    // .cu:258-356): the partial delta is exported, combined with the device
    // side's, and the sweep consumes the externally combined vector
    void set_delta(const double* d) {  // [V][2] interleaved (lo, hi)
        for (int64_t v = 0; v < nr_vars; ++v) {
            delta_lo[v] = d[2 * v];
            delta_hi[v] = d[2 * v + 1];
        }
    }

    void export_delta(double* out) {
        compute_delta();
        for (int64_t v = 0; v < nr_vars; ++v) {
            out[2 * v] = delta_lo[v];
            out[2 * v + 1] = delta_hi[v];
        }
    }

    void half_iteration_ext(double omega, int dir, const double* d) {
        if (!cft_valid) backward_run();
        set_delta(d);
        half_sweep(omega, dir);
    }

    // the sweep body, consuming whatever delta_lo/delta_hi currently hold
    void half_sweep(double omega, int dir) {
        const double INFD = std::numeric_limits<double>::infinity();
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
        for (int64_t b = 0; b < nr_bdds; ++b) {
            const int64_t* lvl = &level_off[lvl_idx[b]];
            const int64_t d = layer_off[b + 1] - layer_off[b];
            const int64_t nb = node_off[b], ne = node_off[b + 1];
            if (dir > 0) {
                for (int64_t i = nb; i < ne; ++i) cfr[i] = INFD;
                cfr[nb] = 0.0;  // root is node 0 of the bdd
            }
            for (int64_t hh = 0; hh < d; ++hh) {
                const int64_t h = dir > 0 ? hh : d - 1 - hh;
                const int64_t l = layer_off[b] + h;
                // min marginals of this layer from cfr (current fwd state or
                // cached) + cft (cached or current bwd state)
                double m0 = INFD, m1 = INFD;
                const double cl = lo_cost[l], ch = hi_cost[l];
                for (int64_t i = lvl[h]; i < lvl[h + 1]; ++i) {
                    const double r = cfr[i];
                    m0 = std::min(m0, r + cl + term_cft(lo_arc[i], cft.data()));
                    m1 = std::min(m1, r + ch + term_cft(hi_arc[i], cft.data()));
                }
                const int32_t v = layer_var[l];
                layer_update(m0, m1, omega, 1.0 / (double)nbpv[v], delta_lo[v],
                             delta_hi[v], lo_cost[l], hi_cost[l], def_mm[l]);
                // propagate with updated costs
                const double nl = lo_cost[l], nh = hi_cost[l];
                if (dir > 0) {
                    for (int64_t i = lvl[h]; i < lvl[h + 1]; ++i) {
                        const double r = cfr[i];
                        const int64_t a0 = lo_arc[i], a1 = hi_arc[i];
                        if (a0 >= 0) cfr[a0] = std::min(cfr[a0], r + nl);
                        if (a1 >= 0) cfr[a1] = std::min(cfr[a1], r + nh);
                    }
                } else {
                    for (int64_t i = lvl[h]; i < lvl[h + 1]; ++i)
                        cft[i] = std::min(term_cft(lo_arc[i], cft.data()) + nl,
                                          term_cft(hi_arc[i], cft.data()) + nh);
                }
            }
        }
    }

    void iteration(double omega) {
        if (!cft_valid) backward_run();
        half_iteration(omega, +1);
        half_iteration(omega, -1);
    }

    // The bound's sum runs serially in BDD order: an OpenMP reduction
    // combines its threads' partial sums in the order they arrive, so its
    // last bit changed from call to call (native/bdd_host.cpp still does so).
    double lower_bound() {
        if (!cft_valid) backward_run();
        double lb = 0.0;
        for (int64_t b = 0; b < nr_bdds; ++b) lb += cft[node_off[b]];
        return lb;
    }

    // bound after distributing the deferred deltas (does not mutate state)
    double lower_bound_deferred() {
        compute_delta();
        return lb_deferred_current();
    }

    // same, with an externally combined delta (hybrid consensus: the device
    // side's contributions are already summed into delta_lo/delta_hi)
    double lower_bound_deferred_ext(const double* d) {
        set_delta(d);
        return lb_deferred_current();
    }

    double lb_deferred_current() {
        std::vector<double> slo(lo_cost), shi(hi_cost), scft(nr_nodes);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int64_t l = 0; l < nr_layers; ++l) {
            const int32_t v = layer_var[l];
            const double a = 1.0 / (double)nbpv[v];
            slo[l] += a * delta_lo[v];
            shi[l] += a * delta_hi[v];
        }
        // each BDD's root cost into its own entry under any schedule, then
        // one serial sum in BDD order: the same bits on every call
        std::vector<double> root(nr_bdds);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
        for (int64_t b = 0; b < nr_bdds; ++b) {
            const int64_t* lvl = &level_off[lvl_idx[b]];
            const int64_t d = layer_off[b + 1] - layer_off[b];
            for (int64_t h = d; h-- > 0;) {
                const double cl = slo[layer_off[b] + h];
                const double ch = shi[layer_off[b] + h];
                for (int64_t i = lvl[h]; i < lvl[h + 1]; ++i)
                    scft[i] = std::min(term_cft(lo_arc[i], scft.data()) + cl,
                                       term_cft(hi_arc[i], scft.data()) + ch);
            }
            root[b] = scft[node_off[b]];
        }
        double lb = 0.0;
        for (int64_t b = 0; b < nr_bdds; ++b) lb += root[b];
        return lb;
    }

    // per-layer min marginals with the CURRENT costs (no update): fresh
    // forward run against the cached backward state — the readout the
    // incremental rounding loop needs (semantics of uniform.bucket_min_
    // marginals / ref bdd_cuda_base.cu min_marginals_cuda)
    void min_marginals(double* m0, double* m1) {
        if (!cft_valid) backward_run();
        const double INFD = std::numeric_limits<double>::infinity();
        // forward pass on a SCRATCH buffer: the persistent cfr holds the
        // half-sweep forward state that a pending backward half_iteration
        // (dir=-1) will consume — clobbering it here would corrupt that
        // sweep. Per-BDD node ranges are disjoint, so one shared scratch
        // vector is race-free under the parallel-for.
        std::vector<double>& sfr = mm_scratch;
        if ((int64_t)sfr.size() != nr_nodes) sfr.assign(nr_nodes, 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
        for (int64_t b = 0; b < nr_bdds; ++b) {
            const int64_t* lvl = &level_off[lvl_idx[b]];
            const int64_t d = layer_off[b + 1] - layer_off[b];
            const int64_t nb = node_off[b], ne = node_off[b + 1];
            for (int64_t i = nb; i < ne; ++i) sfr[i] = INFD;
            sfr[nb] = 0.0;
            for (int64_t h = 0; h < d; ++h) {
                const int64_t l = layer_off[b] + h;
                const double cl = lo_cost[l], ch = hi_cost[l];
                double a0 = INFD, a1 = INFD;
                for (int64_t i = lvl[h]; i < lvl[h + 1]; ++i) {
                    const double r = sfr[i];
                    a0 = std::min(a0, r + cl + term_cft(lo_arc[i], cft.data()));
                    a1 = std::min(a1, r + ch + term_cft(hi_arc[i], cft.data()));
                    const int64_t c0 = lo_arc[i], c1 = hi_arc[i];
                    if (c0 >= 0) sfr[c0] = std::min(sfr[c0], r + cl);
                    if (c1 >= 0) sfr[c1] = std::min(sfr[c1], r + ch);
                }
                m0[l] = a0;
                m1[l] = a1;
            }
        }
    }

    // add per-variable cost deltas split by the isotropic weights (ref:
    // update_costs, bdd_cuda_base.cu:1397-1437 / uniform.update_costs_per_
    // var — the rounding perturbation path)
    void update_costs_per_var(const double* lo_u, const double* hi_u) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int64_t l = 0; l < nr_layers; ++l) {
            const int32_t v = layer_var[l];
            const double a = 1.0 / (double)nbpv[v];
            lo_cost[l] += a * lo_u[v];
            hi_cost[l] += a * hi_u[v];
        }
        cft_valid = false;
    }

    // fold an externally combined deferred delta into the layer costs and
    // clear the ledger (hybrid side of uniform.distribute_delta)
    void distribute_delta_ext(const double* d) {
        set_delta(d);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int64_t l = 0; l < nr_layers; ++l) {
            const int32_t v = layer_var[l];
            const double a = 1.0 / (double)nbpv[v];
            lo_cost[l] += a * delta_lo[v];
            hi_cost[l] += a * delta_hi[v];
            def_mm[l] = 0.0;
        }
        cft_valid = false;
    }
};

}  // namespace bh

// ------------------------------------------------------------------- C ABI

extern "C" {

void* bh_create() { return new bh::Context(); }
void bh_destroy(void* ctx) { delete (bh::Context*)ctx; }

const char* bh_error(void* ctx) { return ((bh::Context*)ctx)->err.c_str(); }

int bh_parse_lp(void* ctx, const char* text) {
    auto* c = (bh::Context*)ctx;
    std::string t(text);
    if (!bh::parse_lp(t, c->ilp, c->err)) return -1;
    return 0;
}

int bh_reorder(void* ctx, int mode) {
    auto* c = (bh::Context*)ctx;
    if (mode == 0) return 0;
    auto order = mode == 3 ? bh::min_degree_order(c->ilp)
                           : bh::bfs_order(c->ilp, mode == 2, mode == 2);
    bh::apply_order(c->ilp, order);
    c->last_order = order;
    return 0;
}

// old variable index at new position i of the last reorder; -1 when no
// reorder was applied (identity) or i out of range
int bh_var_order(void* ctx, int i) {
    auto* c = (bh::Context*)ctx;
    if (i < 0 || i >= (int)c->last_order.size()) return -1;
    return c->last_order[i];
}

// returns nr buckets, -1 infeasible, -2 error
int bh_build(void* ctx) {
    auto* c = (bh::Context*)ctx;
    try {
        if (!c->build()) return -1;
    } catch (const std::exception& e) {
        c->err = e.what();
        return -2;
    }
    return (int)c->buckets.size();
}

int bh_nr_vars(void* ctx) { return (int)((bh::Context*)ctx)->ilp.var_names.size(); }
int bh_nr_bdds(void* ctx) { return (int)((bh::Context*)ctx)->col.bdds.size(); }
int bh_nr_constraints(void* ctx) {
    return (int)((bh::Context*)ctx)->ilp.constraints.size();
}
double bh_constant(void* ctx) { return ((bh::Context*)ctx)->ilp.constant; }

void bh_objective(void* ctx, double* out) {
    auto* c = (bh::Context*)ctx;
    std::memcpy(out, c->ilp.objective.data(),
                c->ilp.objective.size() * sizeof(double));
}

const char* bh_var_name(void* ctx, int i) {
    return ((bh::Context*)ctx)->ilp.var_names[i].c_str();
}

void bh_bucket_shape(void* ctx, int k, int* H, int* P, int* B, int* nB) {
    auto& bk = ((bh::Context*)ctx)->buckets[k];
    *H = bk.H;
    *P = bk.P;
    *B = bk.B;
    *nB = bk.nB;
}

void bh_fill_bucket(void* ctx, int k, int8_t* node_valid, int8_t* lo_kind,
                    int32_t* lo_slot, int8_t* hi_kind, int32_t* hi_slot,
                    int8_t* layer_valid, int32_t* layer_var,
                    int64_t* bdd_of_col, int32_t* depths) {
    auto& bk = ((bh::Context*)ctx)->buckets[k];
    std::memcpy(node_valid, bk.node_valid.data(), bk.node_valid.size());
    std::memcpy(lo_kind, bk.lo_kind.data(), bk.lo_kind.size());
    std::memcpy(lo_slot, bk.lo_slot.data(), bk.lo_slot.size() * sizeof(int32_t));
    std::memcpy(hi_kind, bk.hi_kind.data(), bk.hi_kind.size());
    std::memcpy(hi_slot, bk.hi_slot.data(), bk.hi_slot.size() * sizeof(int32_t));
    std::memcpy(layer_valid, bk.layer_valid.data(), bk.layer_valid.size());
    std::memcpy(layer_var, bk.layer_var.data(),
                bk.layer_var.size() * sizeof(int32_t));
    std::memcpy(bdd_of_col, bk.bdd_of_col.data(),
                bk.bdd_of_col.size() * sizeof(int64_t));
    std::memcpy(depths, bk.depths.data(), bk.depths.size() * sizeof(int32_t));
}

// flat collection export (for python-side wrapping / parity tests)
void bh_collection_sizes(void* ctx, int64_t* nr_nodes, int64_t* nr_bdds) {
    auto* c = (bh::Context*)ctx;
    int64_t n = 0;
    for (auto& q : c->col.bdds) n += (int64_t)q.level.size();
    *nr_nodes = n;
    *nr_bdds = (int64_t)c->col.bdds.size();
}

void bh_fill_collection(void* ctx, int64_t* var, int64_t* lo, int64_t* hi,
                        int64_t* delim) {
    auto* c = (bh::Context*)ctx;
    int64_t base = 0;
    delim[0] = 0;
    int64_t bi = 0;
    for (auto& q : c->col.bdds) {
        for (size_t i = 0; i < q.level.size(); ++i) {
            var[base + i] = q.vars[q.level[i]];
            lo[base + i] = q.lo[i] < 0 ? q.lo[i] : base + q.lo[i];
            hi[base + i] = q.hi[i] < 0 ? q.hi[i] : base + q.hi[i];
        }
        base += (int64_t)q.level.size();
        delim[++bi] = base;
    }
}

// load a flat qbdd collection (python-preprocessed instances: nonlinear,
// coalesced, split — anything the native parser declines) so the CPU
// baseline solver can run on it. Arrays as in bh_fill_collection: per-node
// global var + lo/hi (global node id or TOPv/BOTv), bdd delimiters.
int bh_load_collection(void* ctx, int64_t nr_vars, int64_t nr_nodes,
                       int64_t nr_bdds, const int64_t* var, const int64_t* lo,
                       const int64_t* hi, const int64_t* delim) {
    auto* c = (bh::Context*)ctx;
    c->col.bdds.clear();
    c->ilp.var_names.resize((size_t)nr_vars);
    c->ilp.objective.assign((size_t)nr_vars, 0.0);
    for (int64_t b = 0; b < nr_bdds; ++b) {
        const int64_t s = delim[b], e = delim[b + 1];
        bh::QbddOut q;
        // support: distinct vars in node order (level-sorted collections)
        std::unordered_map<int64_t, int32_t> level_of;
        for (int64_t i = s; i < e; ++i) {
            auto it = level_of.find(var[i]);
            if (it == level_of.end()) {
                level_of.emplace(var[i], (int32_t)q.vars.size());
                q.vars.push_back((int32_t)var[i]);
            }
        }
        std::vector<int64_t> order(e - s);
        std::iota(order.begin(), order.end(), 0);
        std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t bb) {
            return level_of[var[s + a]] < level_of[var[s + bb]];
        });
        std::vector<int64_t> newid(e - s);
        for (size_t k = 0; k < order.size(); ++k) newid[order[k]] = (int64_t)k;
        q.level.resize(e - s);
        q.lo.resize(e - s);
        q.hi.resize(e - s);
        for (size_t k = 0; k < order.size(); ++k) {
            const int64_t i = s + order[k];
            q.level[k] = level_of[var[i]];
            q.lo[k] = lo[i] < 0 ? lo[i] : newid[lo[i] - s];
            q.hi[k] = hi[i] < 0 ? hi[i] : newid[hi[i] - s];
        }
        // qbdd check: internal arcs go exactly one level down (the solver's
        // backward sweep recomputation order relies on it)
        for (size_t k = 0; k < q.level.size(); ++k) {
            for (int64_t a : {q.lo[k], q.hi[k]})
                if (a >= 0 && q.level[(size_t)a] != q.level[k] + 1) {
                    c->err = "collection is not quasi-reduced";
                    return -2;
                }
        }
        c->col.bdds.push_back(std::move(q));
    }
    return 0;
}

// --- CPU parallel MMA baseline (built from a parsed+built context) ---------

void* bh_cpu_create(void* ctx, const double* objective, const int32_t* nbpv) {
    auto* c = (bh::Context*)ctx;
    auto* s = new bh::CpuSolver();
    try {
        s->build(c->col, (int64_t)c->ilp.var_names.size(), objective, nbpv);
    } catch (const std::exception& e) {
        c->err = e.what();
        delete s;
        return nullptr;
    }
    return s;
}

void bh_cpu_destroy(void* s) { delete (bh::CpuSolver*)s; }

void bh_cpu_iterations(void* s, int n, double omega) {
    auto* sv = (bh::CpuSolver*)s;
    for (int i = 0; i < n; ++i) sv->iteration(omega);
}

double bh_cpu_lower_bound(void* s) { return ((bh::CpuSolver*)s)->lower_bound(); }

double bh_cpu_lower_bound_deferred(void* s) {
    return ((bh::CpuSolver*)s)->lower_bound_deferred();
}

// --- hybrid host+device consensus hooks (solver/hybrid.py) -----------------

void bh_cpu_partial_delta(void* s, double* out) {
    ((bh::CpuSolver*)s)->export_delta(out);
}

void bh_cpu_half_iteration_ext(void* s, double omega, int dir,
                               const double* delta) {
    ((bh::CpuSolver*)s)->half_iteration_ext(omega, dir, delta);
}

double bh_cpu_lower_bound_deferred_ext(void* s, const double* delta) {
    return ((bh::CpuSolver*)s)->lower_bound_deferred_ext(delta);
}

void bh_cpu_min_marginals(void* s, double* m0, double* m1) {
    ((bh::CpuSolver*)s)->min_marginals(m0, m1);
}

void bh_cpu_update_costs(void* s, const double* lo_u, const double* hi_u) {
    ((bh::CpuSolver*)s)->update_costs_per_var(lo_u, hi_u);
}

void bh_cpu_distribute_delta_ext(void* s, const double* delta) {
    ((bh::CpuSolver*)s)->distribute_delta_ext(delta);
}

int bh_cpu_nr_threads(void* s) { return ((bh::CpuSolver*)s)->n_threads; }

int64_t bh_cpu_nr_layers(void* s) { return ((bh::CpuSolver*)s)->nr_layers; }

// layer order is bdd-major; expose (bdd, var) per layer for parity remapping
void bh_cpu_layer_info(void* s, int32_t* bdd, int32_t* var) {
    auto* sv = (bh::CpuSolver*)s;
    for (int64_t b = 0; b < sv->nr_bdds; ++b)
        for (int64_t l = sv->layer_off[b]; l < sv->layer_off[b + 1]; ++l) {
            bdd[l] = (int32_t)b;
            var[l] = sv->layer_var[l];
        }
}

void bh_cpu_get_costs(void* s, double* lo, double* hi, double* mm) {
    auto* sv = (bh::CpuSolver*)s;
    std::memcpy(lo, sv->lo_cost.data(), sv->nr_layers * sizeof(double));
    std::memcpy(hi, sv->hi_cost.data(), sv->nr_layers * sizeof(double));
    std::memcpy(mm, sv->def_mm.data(), sv->nr_layers * sizeof(double));
}

// warm-start the f64 solver from externally computed duals (e.g. the f32
// TPU state at its precision floor — the escalation path that certifies
// 1e-6 gaps at the reference's default double precision). Invalidates the
// cached backward run.
void bh_cpu_set_costs(void* s, const double* lo, const double* hi,
                      const double* mm) {
    auto* sv = (bh::CpuSolver*)s;
    std::memcpy(sv->lo_cost.data(), lo, sv->nr_layers * sizeof(double));
    std::memcpy(sv->hi_cost.data(), hi, sv->nr_layers * sizeof(double));
    std::memcpy(sv->def_mm.data(), mm, sv->nr_layers * sizeof(double));
    sv->cft_valid = false;
}

}  // extern "C"
