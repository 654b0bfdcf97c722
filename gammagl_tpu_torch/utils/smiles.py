"""Molecule SMILES -> Graph conversion (counterpart of
`gammagl_tpu/utils/smiles.py`; reference: gammagl/utils/smiles.py).

Requires rdkit; raises a clear ImportError otherwise. Feature vocabulary
follows the reference (atom/bond categorical codes). The `Graph` holds
numpy arrays, as the port's graphs do.
"""

import numpy as np

__all__ = ["from_smiles"]

ATOM_FEATURES = ["atomic_num", "chirality", "degree", "formal_charge",
                 "num_hs", "num_radical_electrons", "hybridization",
                 "is_aromatic", "is_in_ring"]


def from_smiles(smiles, with_hydrogen=False, kekulize=False):
    """SMILES string -> `Graph` with int64 atom features ``x`` (9 codes),
    both directions of each bond in ``edge_index`` and 3 bond codes in
    ``edge_attr``; ``g.smiles`` keeps the string."""
    try:
        from rdkit import Chem
    except ImportError as e:
        raise ImportError("from_smiles requires rdkit") from e
    from gammagl_tpu_torch.data.graph import Graph

    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        raise ValueError(f"could not parse SMILES {smiles!r}")
    if with_hydrogen:
        mol = Chem.AddHs(mol)
    if kekulize:
        Chem.Kekulize(mol)

    xs = []
    for atom in mol.GetAtoms():
        xs.append([
            atom.GetAtomicNum(),
            int(atom.GetChiralTag()),
            atom.GetTotalDegree(),
            atom.GetFormalCharge() + 5,
            atom.GetTotalNumHs(),
            atom.GetNumRadicalElectrons(),
            int(atom.GetHybridization()),
            int(atom.GetIsAromatic()),
            int(atom.IsInRing()),
        ])
    x = np.asarray(xs, np.int64)

    rows, cols, attrs = [], [], []
    for bond in mol.GetBonds():
        i, j = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        attr = [int(bond.GetBondType()), int(bond.GetStereo()),
                int(bond.GetIsConjugated())]
        rows += [i, j]
        cols += [j, i]
        attrs += [attr, attr]
    edge_index = np.asarray([rows, cols], np.int64)
    edge_attr = np.asarray(attrs, np.int64)
    g = Graph(x=x, edge_index=edge_index, edge_attr=edge_attr)
    g.smiles = smiles
    return g
