// Native SMILES featurizer for corpus-scale pretraining data.
//
// Clean-room C++ port of molclr_tpu_torch/chem/smiles.py + the
// featurization tables of molclr_tpu_torch/data/featurize.py (which mirror
// the reference dataset/dataset.py:26-109); a copy of
// molclr_tpu/native/featurizer.cpp. The Python implementation is the
// semantic source of truth; parity is enforced by
// tests/test_torch_port_native.py over the synthetic corpus and real drug
// SMILES.
//
// API (C, ctypes-friendly): one call per molecule writing into
// caller-provided int32 buffers. Returns 0 on success, negative on parse
// failure. Thread-safe (no globals).
//
// Build: g++ -O2 -shared -fPIC, at first use, into build/native/
// (molclr_tpu_torch/native/__init__.py).

#include <cctype>
#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {

constexpr int MAX_ATOMS = 1024;
constexpr int MAX_BONDS = 2048;
constexpr int MAX_RINGS = 100;

// chirality indices match CHIRALITY_LIST (ref dataset/dataset.py:27-32)
enum Chir { CHI_NONE = 0, CHI_CW = 1, CHI_CCW = 2, CHI_OTHER = 3 };
// bond types match BOND_LIST (ref dataset/dataset.py:33-38)
enum BType { B_SINGLE = 0, B_DOUBLE = 1, B_TRIPLE = 2, B_AROMATIC = 3 };
enum BDir { D_NONE = 0, D_UP = 1, D_DOWN = 2 };

struct Atom {
  int z = 0;
  int charge = 0;
  int chir = CHI_NONE;
  bool aromatic = false;
  int explicit_h = -1;  // -1 => implicit
};

struct Bond {
  int a1, a2;
  int type;
  int dir;
};

struct Mol {
  Atom atoms[MAX_ATOMS];
  Bond bonds[MAX_BONDS];
  int n_atoms = 0;
  int n_bonds = 0;
};

// element symbols -> atomic number (two-char checked first)
int symbol_z(const char* s, int* len) {
  static const struct { const char* sym; int z; } two[] = {
      {"He", 2}, {"Li", 3}, {"Be", 4}, {"Ne", 10}, {"Na", 11}, {"Mg", 12},
      {"Al", 13}, {"Si", 14}, {"Cl", 17}, {"Ar", 18}, {"Ca", 20}, {"Sc", 21},
      {"Ti", 22}, {"Cr", 24}, {"Mn", 25}, {"Fe", 26}, {"Co", 27}, {"Ni", 28},
      {"Cu", 29}, {"Zn", 30}, {"Ga", 31}, {"Ge", 32}, {"As", 33}, {"Se", 34},
      {"Br", 35}, {"Kr", 36}, {"Rb", 37}, {"Sr", 38}, {"Zr", 40}, {"Nb", 41},
      {"Mo", 42}, {"Tc", 43}, {"Ru", 44}, {"Rh", 45}, {"Pd", 46}, {"Ag", 47},
      {"Cd", 48}, {"In", 49}, {"Sn", 50}, {"Sb", 51}, {"Te", 52}, {"Xe", 54},
      {"Cs", 55}, {"Ba", 56}, {"La", 57}, {"Ce", 58}, {"Pr", 59}, {"Nd", 60},
      {"Pm", 61}, {"Sm", 62}, {"Eu", 63}, {"Gd", 64}, {"Tb", 65}, {"Dy", 66},
      {"Ho", 67}, {"Er", 68}, {"Tm", 69}, {"Yb", 70}, {"Lu", 71}, {"Hf", 72},
      {"Ta", 73}, {"Re", 75}, {"Os", 76}, {"Ir", 77}, {"Pt", 78}, {"Au", 79},
      {"Hg", 80}, {"Tl", 81}, {"Pb", 82}, {"Bi", 83}, {"Po", 84}, {"At", 85},
      {"Rn", 86}, {"Fr", 87}, {"Ra", 88}, {"Ac", 89}, {"Th", 90}, {"Pa", 91},
      {"Np", 93}, {"Pu", 94}, {"Am", 95}, {"Cm", 96}, {"Bk", 97}, {"Cf", 98},
      {"Es", 99}, {"Fm", 100}, {"Md", 101}, {"No", 102}, {"Lr", 103},
  };
  static const struct { char sym; int z; } one[] = {
      {'H', 1}, {'B', 5}, {'C', 6}, {'N', 7}, {'O', 8}, {'F', 9},
      {'P', 15}, {'S', 16}, {'K', 19}, {'V', 23}, {'Y', 39}, {'I', 53},
      {'W', 74}, {'U', 92},
  };
  for (auto& t : two) {
    if (s[0] == t.sym[0] && s[1] == t.sym[1]) {
      *len = 2;
      return t.z;
    }
  }
  for (auto& o : one) {
    if (s[0] == o.sym) {
      *len = 1;
      return o.z;
    }
  }
  *len = 0;
  return 0;
}

// normal valences (OpenSMILES): smallest >= sigma sum
int default_valence(int z, double bos) {
  auto pick = [&](std::initializer_list<int> vs) {
    for (int v : vs)
      if (v >= bos - 1e-9) return v;
    return 0;
  };
  switch (z) {
    case 5: return pick({3});
    case 6: return pick({4});
    case 7: return pick({3, 5});
    case 8: return pick({2});
    case 15: return pick({3, 5});
    case 16: return pick({2, 4, 6});
    case 9: return pick({1});
    case 17: case 35: case 53: return pick({1, 3, 5, 7});
    case 1: return pick({1});
    default: return 0;
  }
}

double bond_order(int t) {
  switch (t) {
    case B_SINGLE: return 1.0;
    case B_DOUBLE: return 2.0;
    case B_TRIPLE: return 3.0;
    case B_AROMATIC: return 1.0;  // sigma part; +1 bonus handled separately
  }
  return 0.0;
}

int implicit_hs(const Mol& m, int idx) {
  const Atom& a = m.atoms[idx];
  if (a.explicit_h >= 0) return a.explicit_h;
  double sigma = 0.0;
  int n_arom = 0;
  for (int b = 0; b < m.n_bonds; ++b) {
    if (m.bonds[b].a1 == idx || m.bonds[b].a2 == idx) {
      sigma += bond_order(m.bonds[b].type);
      if (m.bonds[b].type == B_AROMATIC) n_arom++;
    }
  }
  double bonus = n_arom > 0 ? 1.0 : 0.0;
  int dv = default_valence(a.z, sigma);
  if (dv == 0) return 0;
  int eff = dv;
  if (a.z == 7 || a.z == 15 || a.z == 5) eff = dv + a.charge;
  else if ((a.z == 8 || a.z == 16 || a.z == 34 || a.z == 52) && a.charge != 0)
    eff = dv + a.charge;
  else if (a.z == 6 && a.charge != 0)
    eff = dv - (a.charge > 0 ? a.charge : -a.charge);
  int n = (int)(eff - sigma - bonus + 0.5);
  return n > 0 ? n : 0;
}

struct RingSlot {
  int atom = -1;
  int btype = -1;   // -1 = unspecified
  int bdir = D_NONE;
};

bool add_bond(Mol& m, int a1, int a2, int type, int dir) {
  if (m.n_bonds >= MAX_BONDS) return false;
  m.bonds[m.n_bonds++] = {a1, a2, type, dir};
  return true;
}

// Parse a bracket atom body (between '[' and ']').
bool parse_bracket(const char* s, int len, Atom* out) {
  int i = 0;
  while (i < len && isdigit(s[i])) i++;  // isotope (ignored in features)
  if (i >= len) return false;
  Atom a;
  if (s[i] == '*') {
    a.z = 0;
    i++;
  } else if (islower(s[i])) {
    char up[3] = {(char)toupper(s[i]), 0, 0};
    // aromatic two-char: se, as, te, si
    if (i + 1 < len && islower(s[i + 1]) &&
        ((s[i] == 's' && (s[i + 1] == 'e' || s[i + 1] == 'i')) ||
         (s[i] == 'a' && s[i + 1] == 's') ||
         (s[i] == 't' && s[i + 1] == 'e'))) {
      up[1] = s[i + 1];
      i += 2;
    } else {
      if (!strchr("bcnops", s[i])) return false;
      i += 1;
    }
    int l = 0;
    a.z = symbol_z(up, &l);
    if (a.z == 0) return false;
    a.aromatic = true;
  } else {
    int l = 0;
    a.z = symbol_z(s + i, &l);
    if (a.z == 0 || i + l > len) return false;
    i += l;
  }
  if (i < len && s[i] == '@') {
    if (i + 1 < len && s[i + 1] == '@') {
      a.chir = CHI_CW;
      i += 2;
    } else {
      a.chir = CHI_CCW;
      i += 1;
    }
    // extended classes -> OTHER
    if (i + 1 < len &&
        ((s[i] == 'T' && s[i + 1] == 'H') || (s[i] == 'A' && s[i + 1] == 'L') ||
         (s[i] == 'S' && s[i + 1] == 'P') || (s[i] == 'T' && s[i + 1] == 'B') ||
         (s[i] == 'O' && s[i + 1] == 'H'))) {
      a.chir = CHI_OTHER;
      i += 2;
      while (i < len && isdigit(s[i])) i++;
    }
  }
  a.explicit_h = 0;
  if (i < len && s[i] == 'H') {
    i++;
    a.explicit_h = 1;
    int num = 0, got = 0;
    while (i < len && isdigit(s[i])) {
      num = num * 10 + (s[i] - '0');
      i++;
      got = 1;
    }
    if (got) a.explicit_h = num;
  }
  while (i < len && (s[i] == '+' || s[i] == '-')) {
    int sign = s[i] == '+' ? 1 : -1;
    i++;
    int num = 0, got = 0;
    while (i < len && isdigit(s[i])) {
      num = num * 10 + (s[i] - '0');
      i++;
      got = 1;
    }
    if (got) {
      a.charge += sign * num;
    } else {
      a.charge += sign;
      while (i < len && ((sign == 1 && s[i] == '+') ||
                         (sign == -1 && s[i] == '-'))) {
        a.charge += sign;
        i++;
      }
    }
  }
  if (i < len && s[i] == ':') {  // atom map, ignored
    i++;
    if (i >= len || !isdigit(s[i])) return false;
    while (i < len && isdigit(s[i])) i++;
  }
  if (i != len) return false;
  *out = a;
  return true;
}

bool parse_smiles(const char* s, Mol& m) {
  int i = 0;
  int n = (int)strlen(s);
  int prev = -1;
  int pend_type = -1;  // -1 none
  int pend_dir = D_NONE;
  int stack[MAX_ATOMS];
  int sp = 0;
  RingSlot rings[MAX_RINGS];

  auto attach = [&](int idx) -> bool {
    if (prev >= 0) {
      int bt = pend_type;
      if (bt < 0)
        bt = (m.atoms[prev].aromatic && m.atoms[idx].aromatic) ? B_AROMATIC
                                                              : B_SINGLE;
      if (!add_bond(m, prev, idx, bt, pend_dir)) return false;
    }
    prev = idx;
    pend_type = -1;
    pend_dir = D_NONE;
    return true;
  };

  auto close_ring = [&](int num) -> bool {
    if (prev < 0 || num >= MAX_RINGS) return false;
    RingSlot& r = rings[num];
    if (r.atom >= 0) {
      int bt = pend_type >= 0 ? pend_type : r.btype;
      if (bt < 0)
        bt = (m.atoms[r.atom].aromatic && m.atoms[prev].aromatic) ? B_AROMATIC
                                                                  : B_SINGLE;
      int bd = pend_dir != D_NONE ? pend_dir : r.bdir;
      if (r.atom == prev) return false;
      if (!add_bond(m, r.atom, prev, bt, bd)) return false;
      r.atom = -1;
    } else {
      r.atom = prev;
      r.btype = pend_type;
      r.bdir = pend_dir;
    }
    pend_type = -1;
    pend_dir = D_NONE;
    return true;
  };

  while (i < n) {
    char c = s[i];
    switch (c) {
      // a second bond symbol ("C==C") is an error, as in chem/smiles.py;
      // only '/' and '\\' may follow one
      case '-': if (pend_type >= 0) return false;
                pend_type = B_SINGLE; i++; break;
      case '=': if (pend_type >= 0) return false;
                pend_type = B_DOUBLE; i++; break;
      case '#': if (pend_type >= 0) return false;
                pend_type = B_TRIPLE; i++; break;
      case ':': if (pend_type >= 0) return false;
                pend_type = B_AROMATIC; i++; break;
      case '/': pend_type = B_SINGLE; pend_dir = D_UP; i++; break;
      case '\\': pend_type = B_SINGLE; pend_dir = D_DOWN; i++; break;
      case '(':
        if (sp >= MAX_ATOMS) return false;
        stack[sp++] = prev;
        i++;
        break;
      case ')':
        if (sp == 0) return false;
        prev = stack[--sp];
        i++;
        break;
      case '.':
        prev = -1;
        pend_type = -1;
        pend_dir = D_NONE;
        i++;
        break;
      case '%': {
        if (i + 2 >= n || !isdigit(s[i + 1]) || !isdigit(s[i + 2]))
          return false;
        if (!close_ring((s[i + 1] - '0') * 10 + (s[i + 2] - '0')))
          return false;
        i += 3;
        break;
      }
      case '[': {
        const char* end = strchr(s + i, ']');
        if (!end) return false;
        Atom a;
        if (!parse_bracket(s + i + 1, (int)(end - s - i - 1), &a))
          return false;
        if (m.n_atoms >= MAX_ATOMS) return false;
        m.atoms[m.n_atoms] = a;
        if (!attach(m.n_atoms)) return false;
        m.n_atoms++;
        i = (int)(end - s) + 1;
        break;
      }
      case '*': {
        if (m.n_atoms >= MAX_ATOMS) return false;
        Atom a;
        a.z = 0;
        a.explicit_h = 0;
        m.atoms[m.n_atoms] = a;
        if (!attach(m.n_atoms)) return false;
        m.n_atoms++;
        i++;
        break;
      }
      default: {
        if (isdigit(c)) {
          if (!close_ring(c - '0')) return false;
          i++;
          break;
        }
        Atom a;
        if (c == 'C' && s[i + 1] == 'l') {
          a.z = 17;
          i += 2;
        } else if (c == 'B' && s[i + 1] == 'r') {
          a.z = 35;
          i += 2;
        } else if (c == 'B' || c == 'C' || c == 'N' || c == 'O' ||
                   c == 'P' || c == 'S' || c == 'F' || c == 'I') {
          int l;
          char sym[2] = {c, 0};
          a.z = symbol_z(sym, &l);
          i++;
        } else if (islower(c) && strchr("bcnops", c)) {
          int l;
          char sym[2] = {(char)toupper(c), 0};
          a.z = symbol_z(sym, &l);
          a.aromatic = true;
          i++;
        } else {
          return false;
        }
        if (m.n_atoms >= MAX_ATOMS) return false;
        m.atoms[m.n_atoms] = a;
        if (!attach(m.n_atoms)) return false;
        m.n_atoms++;
        break;
      }
    }
  }
  if (sp != 0 || m.n_atoms == 0) return false;
  for (int r = 0; r < MAX_RINGS; ++r)
    if (rings[r].atom >= 0) return false;
  return true;
}

// ---- Hückel aromaticity perception (mirrors chem/aromatic.py; the Python
// module is the semantic source of truth, pinned by
// tests/test_torch_port_native.py) --

constexpr int MAX_SSSR = 128;
constexpr int MAX_RING = 64;  // = chem/aromatic.py MAX_AROMATIC_RING

// pi-electron contribution of ring atom a, or -1 if it disqualifies the ring
int pi_contribution(const Mol& m, int a, const bool* in_ring_set,
                    const bool* ring_atom, const int* inc, int deg) {
  const Atom& at = m.atoms[a];
  if (deg > 3) return -1;
  int n_dbl = 0, n_arom = 0;
  bool ring_dbl = false, exo_ring_dbl = false;
  int exo_acyc_dbl_z = 0;
  for (int k = 0; k < deg; ++k) {
    const Bond& b = m.bonds[inc[k]];
    int other = (b.a1 == a) ? b.a2 : b.a1;
    if (b.type == B_TRIPLE) return -1;
    if (b.type == B_AROMATIC) n_arom++;
    if (b.type == B_DOUBLE) {
      n_dbl++;
      if (in_ring_set[other]) ring_dbl = true;
      else if (ring_atom[other]) exo_ring_dbl = true;
      else exo_acyc_dbl_z = m.atoms[other].z;
    }
  }
  if (n_dbl > 1) return -1;
  int n_sigma = deg + implicit_hs(m, a);
  bool exo_electroneg = (exo_acyc_dbl_z == 7 || exo_acyc_dbl_z == 8 ||
                         exo_acyc_dbl_z == 16);
  int z = at.z;
  if (at.aromatic || n_arom > 0) {
    if (z == 6) return exo_electroneg ? 0 : 1;
    if (z == 7 || z == 15) return (n_sigma == 3 && n_dbl == 0) ? 2 : 1;
    if (z == 8 || z == 16 || z == 34 || z == 52) return 2;
    if (z == 5) return 0;
    return -1;
  }
  if (ring_dbl || exo_ring_dbl) return 1;
  if (exo_acyc_dbl_z != 0) {
    if (z == 6 && exo_electroneg) return 0;
    // exocyclic C=C to an acyclic carbon: sp2-capable, 0 pi electrons
    // (mirrors chem/aromatic.py; fulvene fails on the count, not by
    // disqualification)
    if (z == 6 && exo_acyc_dbl_z == 6) return 0;
    if ((z == 7 || z == 15) && exo_electroneg) return 1;
    return -1;
  }
  // no double bonds
  if (z == 6) {
    if (at.charge == -1) return 2;
    if (at.charge == 1) return 0;
    return -1;
  }
  if (z == 7 || z == 15) return at.charge == 0 ? 2 : -1;
  if (z == 8 || z == 16 || z == 34 || z == 52) return at.charge == 0 ? 2 : -1;
  if (z == 5) return 0;
  return -1;
}

void perceive_aromaticity(Mol& m) {
  int n = m.n_atoms;
  if (n == 0 || m.n_bonds == 0) return;

  // SSSR approximation: per ring bond, the shortest cycle through it
  // (BFS avoiding the bond), deduplicated by membership.
  static thread_local int rings_buf[MAX_SSSR][MAX_RING];
  static thread_local int ring_key[MAX_SSSR][MAX_RING];
  int ring_len[MAX_SSSR];
  int n_rings = 0;
  bool ring_atom[MAX_ATOMS];
  memset(ring_atom, 0, sizeof(bool) * n);

  for (int bi = 0; bi < m.n_bonds; ++bi) {
    int a1 = m.bonds[bi].a1, a2 = m.bonds[bi].a2;
    int prev[MAX_ATOMS];
    for (int i = 0; i < n; ++i) prev[i] = -2;
    int q[MAX_ATOMS];
    int qh = 0, qt = 0;
    prev[a1] = -1;
    q[qt++] = a1;
    while (qh < qt && prev[a2] == -2) {
      int u = q[qh++];
      for (int bj = 0; bj < m.n_bonds; ++bj) {
        if (bj == bi) continue;
        const Bond& b = m.bonds[bj];
        int v;
        if (b.a1 == u) v = b.a2;
        else if (b.a2 == u) v = b.a1;
        else continue;
        if (prev[v] != -2) continue;
        prev[v] = u;
        q[qt++] = v;
      }
    }
    if (prev[a2] == -2) continue;  // bridge bond, no ring
    int path[MAX_ATOMS];
    int plen = 0;
    for (int u = a2; u != -1; u = prev[u]) path[plen++] = u;
    for (int k = 0; k < plen; ++k) ring_atom[path[k]] = true;
    if (plen < 3 || plen > MAX_RING || n_rings >= MAX_SSSR) continue;
    int key[MAX_RING];
    memcpy(key, path, plen * sizeof(int));
    for (int x = 1; x < plen; ++x) {  // insertion sort
      int v = key[x], y = x - 1;
      while (y >= 0 && key[y] > v) { key[y + 1] = key[y]; y--; }
      key[y + 1] = v;
    }
    bool dup = false;
    for (int r = 0; r < n_rings && !dup; ++r)
      dup = ring_len[r] == plen &&
            memcmp(ring_key[r], key, plen * sizeof(int)) == 0;
    if (dup) continue;
    memcpy(rings_buf[n_rings], path, plen * sizeof(int));
    memcpy(ring_key[n_rings], key, plen * sizeof(int));
    ring_len[n_rings++] = plen;
  }
  if (n_rings == 0) return;

  // incident bond lists (capped at 4; degree > 4 can't be aromatic anyway)
  static thread_local int inc[MAX_ATOMS][4];
  int deg[MAX_ATOMS];
  memset(deg, 0, sizeof(int) * n);
  for (int bi = 0; bi < m.n_bonds; ++bi) {
    for (int end = 0; end < 2; ++end) {
      int a = end ? m.bonds[bi].a2 : m.bonds[bi].a1;
      if (deg[a] < 4) inc[a][deg[a]] = bi;
      deg[a]++;
    }
  }

  bool aromatic_ring[MAX_SSSR];
  bool eligible[MAX_SSSR];
  bool any = false;
  bool in_set[MAX_ATOMS];
  for (int r = 0; r < n_rings; ++r) {
    memset(in_set, 0, sizeof(bool) * n);
    for (int k = 0; k < ring_len[r]; ++k) in_set[rings_buf[r][k]] = true;
    int total = 0;
    bool ok = true;
    for (int k = 0; k < ring_len[r] && ok; ++k) {
      int a = rings_buf[r][k];
      int c = pi_contribution(m, a, in_set, ring_atom, inc[a], deg[a]);
      if (c < 0) ok = false;
      else total += c;
    }
    eligible[r] = ok;
    aromatic_ring[r] = ok && (total % 4 == 2);
    any |= aromatic_ring[r];
  }

  // ---- fused-ring envelope pass (mirrors _fused_envelope_pass in
  // chem/aromatic.py): an eligible atom's contribution is member-set
  // independent (in-ring double and fused-ring double both give 1), so a
  // connected union of eligible rings is aromatic iff the sum over its
  // atom set is 4n+2 (azulene 5+7, indolizine bridgehead-N 6-ring).
  constexpr int MAX_FUSED = 10;
  {
    // static per-atom contributions (member set := all ring atoms)
    int ac[MAX_ATOMS];
    for (int i = 0; i < n; ++i) ac[i] = -9;
    for (int r = 0; r < n_rings; ++r) {
      if (!eligible[r]) continue;
      for (int k = 0; k < ring_len[r]; ++k) {
        int a = rings_buf[r][k];
        if (ac[a] == -9)
          ac[a] = pi_contribution(m, a, ring_atom, ring_atom, inc[a],
                                  deg[a]);
      }
    }
    // shared-bond ring adjacency over eligible rings
    static thread_local bool rbond[MAX_SSSR][MAX_BONDS];
    for (int r = 0; r < n_rings; ++r) {
      if (!eligible[r]) continue;
      memset(rbond[r], 0, sizeof(bool) * m.n_bonds);
      int len = ring_len[r];
      for (int k = 0; k < len; ++k) {
        int u = rings_buf[r][k], v = rings_buf[r][(k + 1) % len];
        for (int bj = 0; bj < m.n_bonds; ++bj) {
          const Bond& b = m.bonds[bj];
          if ((b.a1 == u && b.a2 == v) || (b.a1 == v && b.a2 == u))
            rbond[r][bj] = true;
        }
      }
    }
    bool radj[MAX_SSSR][MAX_SSSR];
    for (int r = 0; r < n_rings; ++r)
      for (int s = 0; s < n_rings; ++s) radj[r][s] = false;
    for (int r = 0; r < n_rings; ++r) {
      if (!eligible[r]) continue;
      for (int s = r + 1; s < n_rings; ++s) {
        if (!eligible[s]) continue;
        for (int bj = 0; bj < m.n_bonds; ++bj)
          if (rbond[r][bj] && rbond[s][bj]) {
            radj[r][s] = radj[s][r] = true;
            break;
          }
      }
    }
    // connected components, then subset enumeration per component
    bool visited[MAX_SSSR];
    memset(visited, 0, sizeof(bool) * n_rings);
    for (int root = 0; root < n_rings; ++root) {
      if (visited[root] || !eligible[root]) continue;
      int comp[MAX_SSSR];
      int csz = 0;
      int stack[MAX_SSSR];
      int sp = 0;
      stack[sp++] = root;
      visited[root] = true;
      while (sp) {
        int u = stack[--sp];
        comp[csz++] = u;
        for (int v = 0; v < n_rings; ++v)
          if (radj[u][v] && !visited[v]) {
            visited[v] = true;
            stack[sp++] = v;
          }
      }
      if (csz < 2 || csz > MAX_FUSED) continue;
      for (int mask = 3; mask < (1 << csz); ++mask) {
        int bits = 0;
        bool all_arom = true;
        for (int k = 0; k < csz; ++k)
          if (mask >> k & 1) {
            bits++;
            all_arom = all_arom && aromatic_ring[comp[k]];
          }
        if (bits < 2 || all_arom) continue;
        // subset connectivity over radj
        int first = 0;
        while (!(mask >> first & 1)) first++;
        int seen_mask = 1 << first;
        int order[MAX_FUSED];
        int osz = 0, bp = 0;
        order[osz++] = first;
        while (bp < osz) {
          int ku = order[bp++];
          for (int kv = 0; kv < csz; ++kv)
            if ((mask >> kv & 1) && !(seen_mask >> kv & 1) &&
                radj[comp[ku]][comp[kv]]) {
              seen_mask |= 1 << kv;
              order[osz++] = kv;
            }
        }
        if (seen_mask != mask) continue;
        // union atom set + electron total
        memset(in_set, 0, sizeof(bool) * n);
        int total = 0;
        for (int k = 0; k < csz; ++k) {
          if (!(mask >> k & 1)) continue;
          int r = comp[k];
          for (int j = 0; j < ring_len[r]; ++j) {
            int a = rings_buf[r][j];
            if (!in_set[a]) {
              in_set[a] = true;
              total += ac[a];
            }
          }
        }
        if (total % 4 == 2) {
          for (int k = 0; k < csz; ++k)
            if (mask >> k & 1) aromatic_ring[comp[k]] = true;
          any = true;
        }
      }
    }
  }
  if (!any) return;

  // freeze H counts before mutating bonds, then aromatize
  bool affected[MAX_ATOMS];
  memset(affected, 0, sizeof(bool) * n);
  int h_before[MAX_ATOMS];
  for (int r = 0; r < n_rings; ++r) {
    if (!aromatic_ring[r]) continue;
    for (int k = 0; k < ring_len[r]; ++k) {
      int a = rings_buf[r][k];
      if (!affected[a]) {
        affected[a] = true;
        h_before[a] = implicit_hs(m, a);
      }
    }
  }
  for (int r = 0; r < n_rings; ++r) {
    if (!aromatic_ring[r]) continue;
    int len = ring_len[r];
    for (int k = 0; k < len; ++k) {
      int u = rings_buf[r][k], v = rings_buf[r][(k + 1) % len];
      m.atoms[u].aromatic = true;
      for (int bj = 0; bj < m.n_bonds; ++bj) {
        Bond& b = m.bonds[bj];
        if ((b.a1 == u && b.a2 == v) || (b.a1 == v && b.a2 == u))
          b.type = B_AROMATIC;
      }
    }
  }
  for (int a = 0; a < n; ++a) {
    if (affected[a] && m.atoms[a].explicit_h < 0 &&
        implicit_hs(m, a) != h_before[a])
      m.atoms[a].explicit_h = h_before[a];
  }
}

// RDKit-sanitization parity for aromatic-WRITTEN input (mirrors
// chem/aromatic.py sanitize_input_aromaticity; runs after
// perceive_aromaticity). Demotes AROMATIC-typed bonds outside any ring
// to SINGLE (biphenyl written c1ccc(cc1)c1ccccc1: RDKit reports a
// single linker bond), rejects lowercase atoms in no ring ("cc"), and
// rejects standalone plain-carbon aromatic rings violating 4n+2
// ("c1ccc1"). Returns false iff the input is invalid.
bool sanitize_aromatic(Mol& m, const bool* input_aromatic) {
  int n = m.n_atoms;
  bool ring_bond[MAX_BONDS];
  bool ring_atom[MAX_ATOMS];
  memset(ring_atom, 0, sizeof(bool) * n);

  // ring-bond flag: bi lies on a cycle iff its endpoints stay connected
  // with bi removed (same BFS as the SSSR builder above); collect the
  // deduplicated shortest rings for the 4n+2 check as we go
  static thread_local int rings_buf[MAX_SSSR][MAX_RING];
  static thread_local int ring_key[MAX_SSSR][MAX_RING];
  int ring_len[MAX_SSSR];
  int n_rings = 0;
  for (int bi = 0; bi < m.n_bonds; ++bi) {
    int a1 = m.bonds[bi].a1, a2 = m.bonds[bi].a2;
    int prev[MAX_ATOMS];
    for (int i = 0; i < n; ++i) prev[i] = -2;
    int q[MAX_ATOMS];
    int qh = 0, qt = 0;
    prev[a1] = -1;
    q[qt++] = a1;
    while (qh < qt && prev[a2] == -2) {
      int u = q[qh++];
      for (int bj = 0; bj < m.n_bonds; ++bj) {
        if (bj == bi) continue;
        const Bond& b = m.bonds[bj];
        int v;
        if (b.a1 == u) v = b.a2;
        else if (b.a2 == u) v = b.a1;
        else continue;
        if (prev[v] != -2) continue;
        prev[v] = u;
        q[qt++] = v;
      }
    }
    ring_bond[bi] = prev[a2] != -2;
    if (!ring_bond[bi]) continue;
    ring_atom[a1] = ring_atom[a2] = true;
    int path[MAX_ATOMS];
    int plen = 0;
    for (int u = a2; u != -1; u = prev[u]) path[plen++] = u;
    for (int k = 0; k < plen; ++k) ring_atom[path[k]] = true;
    if (plen < 3 || plen > MAX_RING || n_rings >= MAX_SSSR) continue;
    int key[MAX_RING];
    memcpy(key, path, plen * sizeof(int));
    for (int x = 1; x < plen; ++x) {
      int v = key[x], y = x - 1;
      while (y >= 0 && key[y] > v) { key[y + 1] = key[y]; y--; }
      key[y + 1] = v;
    }
    bool dup = false;
    for (int r = 0; r < n_rings && !dup; ++r)
      dup = ring_len[r] == plen &&
            memcmp(ring_key[r], key, plen * sizeof(int)) == 0;
    if (dup) continue;
    memcpy(rings_buf[n_rings], path, plen * sizeof(int));
    memcpy(ring_key[n_rings], key, plen * sizeof(int));
    ring_len[n_rings++] = plen;
  }

  for (int bi = 0; bi < m.n_bonds; ++bi)
    if (m.bonds[bi].type == B_AROMATIC && !ring_bond[bi])
      m.bonds[bi].type = B_SINGLE;

  for (int a = 0; a < n; ++a)
    if (input_aromatic[a] && !ring_atom[a]) return false;

  int n_memberships[MAX_ATOMS];
  memset(n_memberships, 0, sizeof(int) * n);
  for (int r = 0; r < n_rings; ++r)
    for (int k = 0; k < ring_len[r]; ++k) n_memberships[rings_buf[r][k]]++;
  for (int r = 0; r < n_rings; ++r) {
    bool plain = true;
    for (int k = 0; k < ring_len[r] && plain; ++k) {
      int a = rings_buf[r][k];
      const Atom& at = m.atoms[a];
      plain = input_aromatic[a] && at.z == 6 && at.charge == 0 &&
              n_memberships[a] == 1;
      for (int bj = 0; bj < m.n_bonds && plain; ++bj) {
        const Bond& b = m.bonds[bj];
        if ((b.a1 == a || b.a2 == a) &&
            (b.type == B_DOUBLE || b.type == B_TRIPLE))
          plain = false;
      }
    }
    if (plain && ring_len[r] % 4 != 2) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Featurize one SMILES. Output buffers (int32): atom_type/chirality sized
// >= max_atoms; edge_src/edge_dst/bond_type/bond_dir sized >= 2*max_bonds.
// Writes *n_atoms / *n_bonds. Returns 0 ok, -1 parse error, -2 overflow.
int mtpu_featurize(const char* smiles, int add_hs,
                   int32_t* atom_type, int32_t* chirality,
                   int32_t* edge_src, int32_t* edge_dst,
                   int32_t* bond_type, int32_t* bond_dir,
                   int32_t* n_atoms, int32_t* n_bonds,
                   int32_t max_atoms, int32_t max_bonds) {
  Mol m;
  if (!parse_smiles(smiles, m)) return -1;
  bool input_aromatic[MAX_ATOMS];
  bool any_aromatic = false;
  for (int a = 0; a < m.n_atoms; ++a) {
    input_aromatic[a] = m.atoms[a].aromatic;
    any_aromatic |= input_aromatic[a];
  }
  perceive_aromaticity(m);
  if (any_aromatic && !sanitize_aromatic(m, input_aromatic)) return -1;

  int base_atoms = m.n_atoms;
  if (add_hs) {
    for (int a = 0; a < base_atoms; ++a) {
      int nh = implicit_hs(m, a);
      for (int h = 0; h < nh; ++h) {
        if (m.n_atoms >= MAX_ATOMS || m.n_bonds >= MAX_BONDS) return -2;
        Atom ha;
        ha.z = 1;
        ha.explicit_h = 0;
        m.atoms[m.n_atoms] = ha;
        m.bonds[m.n_bonds++] = {a, m.n_atoms, B_SINGLE, D_NONE};
        m.n_atoms++;
      }
    }
  }

  if (m.n_atoms > max_atoms || m.n_bonds > max_bonds) return -2;
  for (int a = 0; a < m.n_atoms; ++a) {
    atom_type[a] = m.atoms[a].z - 1;  // ATOM_LIST.index == Z-1
    int ch = m.atoms[a].chir;
    chirality[a] = ch >= 3 ? 0 : ch;  // quirk-Q1 fix: OTHER -> UNSPECIFIED
  }
  for (int b = 0; b < m.n_bonds; ++b) {
    edge_src[2 * b] = m.bonds[b].a1;
    edge_dst[2 * b] = m.bonds[b].a2;
    edge_src[2 * b + 1] = m.bonds[b].a2;
    edge_dst[2 * b + 1] = m.bonds[b].a1;
    bond_type[2 * b] = bond_type[2 * b + 1] = m.bonds[b].type;
    bond_dir[2 * b] = bond_dir[2 * b + 1] = m.bonds[b].dir;
  }
  *n_atoms = m.n_atoms;
  *n_bonds = m.n_bonds;
  return 0;
}

// Batch API over a newline-separated buffer; outputs are written
// contiguously with per-molecule offsets. Returns number of successfully
// featurized molecules; failed rows get atom_offsets[i+1]==atom_offsets[i].
int mtpu_featurize_batch(const char* buffer, int64_t buf_len, int add_hs,
                         int32_t* atom_type, int32_t* chirality,
                         int32_t* edge_src, int32_t* edge_dst,
                         int32_t* bond_type, int32_t* bond_dir,
                         int64_t* atom_offsets, int64_t* edge_offsets,
                         int32_t* ok_flags,
                         int64_t atom_capacity, int64_t edge_capacity,
                         int32_t max_mols) {
  int n_ok = 0;
  int mol = 0;
  int64_t apos = 0, epos = 0;
  int64_t i = 0;
  char line[4096];
  atom_offsets[0] = 0;
  edge_offsets[0] = 0;
  while (i < buf_len && mol < max_mols) {
    int64_t j = i;
    while (j < buf_len && buffer[j] != '\n') j++;
    int64_t len = j - i;
    if (len > 0 && len < (int64_t)sizeof(line)) {
      memcpy(line, buffer + i, len);
      line[len] = 0;
      // CSV compatibility: take the last comma field
      char* last = strrchr(line, ',');
      const char* sm = last ? last + 1 : line;
      int32_t na = 0, nb = 0;
      int rc = -2;
      if (apos + MAX_ATOMS <= atom_capacity &&
          epos + 2 * MAX_BONDS <= edge_capacity) {
        rc = mtpu_featurize(sm, add_hs, atom_type + apos, chirality + apos,
                            edge_src + epos, edge_dst + epos,
                            bond_type + epos, bond_dir + epos, &na, &nb,
                            MAX_ATOMS, MAX_BONDS);
      }
      if (rc == 0) {
        apos += na;
        epos += 2 * nb;
        ok_flags[mol] = 1;
        n_ok++;
      } else {
        ok_flags[mol] = 0;
      }
    } else {
      ok_flags[mol] = 0;
    }
    atom_offsets[mol + 1] = apos;
    edge_offsets[mol + 1] = epos;
    mol++;
    i = j + 1;
  }
  return n_ok;
}

// Pack a batch of featurized molecules into one padded flat graph —
// native port of molclr_tpu_torch/data/graphs.py pack_batch (the semantic
// source of truth; exact parity pinned by tests/test_torch_port_native.py).
//
// Inputs are CONCATENATED per-molecule featurization arrays with offset
// tables (atom_off/edge_off, length n_mols+1), as produced by
// mtpu_featurize_batch. `tile` > 0 enforces tile-aligned placement.
// Outputs must be sized to the spec by the caller; this function fills
// every element (padding included).
//
// Returns 0 on success; (1 + gi) if molecule gi overflows node/edge/tile
// capacity (caller drops a molecule and retries, mirroring
// BatchIterator); -1 if a node's degree exceeds ell_slots - 1.
static int pack_batch_impl(
    const int32_t* atom_type, const int32_t* chirality,
    const int64_t* atom_off,
    const int32_t* edge_src, const int32_t* edge_dst,
    const int32_t* bond_type, const int32_t* bond_dir,
    const int64_t* edge_off, const int32_t* mol_ids, int32_t n_mols,
    int32_t cap_nodes, int32_t cap_edges, int32_t ell_slots, int32_t tile,
    int32_t* o_atom_type, int32_t* o_chirality, int32_t* o_node_graph,
    uint8_t* o_node_mask,
    int32_t* o_src, int32_t* o_dst, int32_t* o_bond_type,
    int32_t* o_bond_dir, int32_t* o_edge_bond, uint8_t* o_edge_mask,
    int32_t* o_nbr, int32_t* o_nbr_bt, int32_t* o_nbr_bd,
    int32_t* o_nbr_bond, uint8_t* o_nbr_mask,
    int32_t* o_bond_graph, uint8_t* o_bond_mask,
    uint8_t* o_graph_mask, int32_t* o_graph_n_nodes,
    int32_t* o_graph_n_bonds, int32_t cap_graphs) {
  const int32_t cap_bonds = cap_edges / 2;
  const int32_t K = ell_slots;
  if (cap_nodes > (1 << 20)) return -2;  // slot-counter capacity
  if (n_mols > cap_graphs) return 1 + cap_graphs;

  // padding defaults (graphs.py:26-29: zeros, masks false, sentinel bond)
  for (int32_t i = 0; i < cap_nodes; ++i) {
    o_atom_type[i] = 0; o_chirality[i] = 0; o_node_graph[i] = 0;
    o_node_mask[i] = 0;
    for (int32_t k = 0; k < K; ++k) {
      o_nbr[(int64_t)i * K + k] = 0;
      o_nbr_bt[(int64_t)i * K + k] = 0;
      o_nbr_bd[(int64_t)i * K + k] = 0;
      o_nbr_bond[(int64_t)i * K + k] = cap_bonds;
      o_nbr_mask[(int64_t)i * K + k] = 0;
    }
  }
  for (int32_t e = 0; e < cap_edges; ++e) {
    o_src[e] = 0; o_dst[e] = 0; o_bond_type[e] = 0; o_bond_dir[e] = 0;
    o_edge_bond[e] = cap_bonds; o_edge_mask[e] = 0;
  }
  for (int32_t b = 0; b < cap_bonds; ++b) {
    o_bond_graph[b] = 0; o_bond_mask[b] = 0;
  }
  for (int32_t g = 0; g < cap_graphs; ++g) {
    o_graph_mask[g] = 0; o_graph_n_nodes[g] = 0; o_graph_n_bonds[g] = 0;
  }

  int32_t node_off = 0, eoff_out = 0, bond_off = 0;
  // per-atom ELL fill counters (slot 0 = self-loop)
  static thread_local int16_t slot_cnt[1 << 20];
  for (int32_t gi = 0; gi < n_mols; ++gi) {
    // mol_ids indirection: pack molecule mol_ids[gi] from a corpus-wide
    // offset table (NULL = identity, the contiguous per-batch layout)
    const int32_t mol = mol_ids ? mol_ids[gi] : gi;
    const int64_t a0 = atom_off[mol], a1 = atom_off[mol + 1];
    const int64_t e0 = edge_off[mol], e1 = edge_off[mol + 1];
    const int32_t n = (int32_t)(a1 - a0);
    const int32_t e = (int32_t)(e1 - e0);
    if (tile > 0) {
      if (n > tile) return 1 + gi;
      int32_t used = node_off % tile;
      if (used && used + n > tile) node_off += tile - used;
    }
    if (node_off + n > cap_nodes || eoff_out + e > cap_edges) return 1 + gi;

    for (int32_t i = 0; i < n; ++i) {
      const int32_t row = node_off + i;
      o_atom_type[row] = atom_type[a0 + i];
      o_chirality[row] = chirality[a0 + i];
      o_node_graph[row] = gi;
      o_node_mask[row] = 1;
      // self-loop slot 0 (graphs.py: SELF_LOOP_BOND_TYPE = 4, dir 0)
      o_nbr[(int64_t)row * K] = row;
      o_nbr_bt[(int64_t)row * K] = 4;
      o_nbr_bd[(int64_t)row * K] = 0;
      o_nbr_mask[(int64_t)row * K] = 1;
      slot_cnt[row] = 1;
    }
    for (int32_t j = 0; j < e; ++j) {
      const int32_t row = eoff_out + j;
      const int32_t s = edge_src[e0 + j] + node_off;
      const int32_t d = edge_dst[e0 + j] + node_off;
      o_src[row] = s;
      o_dst[row] = d;
      o_bond_type[row] = bond_type[e0 + j];
      o_bond_dir[row] = bond_dir[e0 + j];
      o_edge_bond[row] = bond_off + j / 2;
      o_edge_mask[row] = 1;
      // ELL: iterate edges in order == stable sort by dst within runs, so
      // slot order matches graphs.py's argsort(kind='stable') assignment
      const int32_t slot = slot_cnt[d]++;
      if (slot >= K) return -1;
      o_nbr[(int64_t)d * K + slot] = s;
      o_nbr_bt[(int64_t)d * K + slot] = bond_type[e0 + j];
      o_nbr_bd[(int64_t)d * K + slot] = bond_dir[e0 + j];
      o_nbr_bond[(int64_t)d * K + slot] = bond_off + j / 2;
      o_nbr_mask[(int64_t)d * K + slot] = 1;
    }
    for (int32_t b = 0; b < e / 2; ++b) {
      o_bond_graph[bond_off + b] = gi;
      o_bond_mask[bond_off + b] = 1;
    }
    o_graph_mask[gi] = 1;
    o_graph_n_nodes[gi] = n;
    o_graph_n_bonds[gi] = e / 2;
    node_off += n;
    eoff_out += e;
    bond_off += e / 2;
  }
  return 0;
}

int mtpu_pack_batch(
    const int32_t* atom_type, const int32_t* chirality,
    const int64_t* atom_off,
    const int32_t* edge_src, const int32_t* edge_dst,
    const int32_t* bond_type, const int32_t* bond_dir,
    const int64_t* edge_off, int32_t n_mols,
    int32_t cap_nodes, int32_t cap_edges, int32_t ell_slots, int32_t tile,
    int32_t* o_atom_type, int32_t* o_chirality, int32_t* o_node_graph,
    uint8_t* o_node_mask,
    int32_t* o_src, int32_t* o_dst, int32_t* o_bond_type,
    int32_t* o_bond_dir, int32_t* o_edge_bond, uint8_t* o_edge_mask,
    int32_t* o_nbr, int32_t* o_nbr_bt, int32_t* o_nbr_bd,
    int32_t* o_nbr_bond, uint8_t* o_nbr_mask,
    int32_t* o_bond_graph, uint8_t* o_bond_mask,
    uint8_t* o_graph_mask, int32_t* o_graph_n_nodes,
    int32_t* o_graph_n_bonds, int32_t cap_graphs) {
  return pack_batch_impl(
      atom_type, chirality, atom_off, edge_src, edge_dst, bond_type,
      bond_dir, edge_off, nullptr, n_mols, cap_nodes, cap_edges, ell_slots,
      tile, o_atom_type, o_chirality, o_node_graph, o_node_mask, o_src,
      o_dst, o_bond_type, o_bond_dir, o_edge_bond, o_edge_mask, o_nbr,
      o_nbr_bt, o_nbr_bd, o_nbr_bond, o_nbr_mask, o_bond_graph,
      o_bond_mask, o_graph_mask, o_graph_n_nodes, o_graph_n_bonds,
      cap_graphs);
}

// Indexed variant for mmap'd corpora (data/corpus.py): per-graph molecule
// ids select segments from the CORPUS-WIDE flat arrays/offset tables, so
// a batch packs straight from the memory-mapped corpus with no
// intermediate per-batch concatenation and no Python object per molecule
// (the streaming hot path, native.IndexedPacker).
int mtpu_pack_batch_indexed(
    const int32_t* atom_type, const int32_t* chirality,
    const int64_t* atom_off,
    const int32_t* edge_src, const int32_t* edge_dst,
    const int32_t* bond_type, const int32_t* bond_dir,
    const int64_t* edge_off, const int32_t* mol_ids, int32_t n_mols,
    int32_t cap_nodes, int32_t cap_edges, int32_t ell_slots, int32_t tile,
    int32_t* o_atom_type, int32_t* o_chirality, int32_t* o_node_graph,
    uint8_t* o_node_mask,
    int32_t* o_src, int32_t* o_dst, int32_t* o_bond_type,
    int32_t* o_bond_dir, int32_t* o_edge_bond, uint8_t* o_edge_mask,
    int32_t* o_nbr, int32_t* o_nbr_bt, int32_t* o_nbr_bd,
    int32_t* o_nbr_bond, uint8_t* o_nbr_mask,
    int32_t* o_bond_graph, uint8_t* o_bond_mask,
    uint8_t* o_graph_mask, int32_t* o_graph_n_nodes,
    int32_t* o_graph_n_bonds, int32_t cap_graphs) {
  return pack_batch_impl(
      atom_type, chirality, atom_off, edge_src, edge_dst, bond_type,
      bond_dir, edge_off, mol_ids, n_mols, cap_nodes, cap_edges, ell_slots,
      tile, o_atom_type, o_chirality, o_node_graph, o_node_mask, o_src,
      o_dst, o_bond_type, o_bond_dir, o_edge_bond, o_edge_mask, o_nbr,
      o_nbr_bt, o_nbr_bd, o_nbr_bond, o_nbr_mask, o_bond_graph,
      o_bond_mask, o_graph_mask, o_graph_n_nodes, o_graph_n_bonds,
      cap_graphs);
}

}  // extern "C"
