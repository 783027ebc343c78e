"""Units and physical constants.

The MDAnalysis standard unit system the reference operates in
(reference docs/source/index.rst: "all calculations and results are in
MDAnalysis standard units"):

* length   — Angstrom (Å)
* time     — picosecond (ps)
* mass     — atomic mass unit (amu)
* velocity — Å/ps
* energy   — kJ/mol

``constants`` mirrors ``MDAnalysis.units.constants`` as consumed at
reference viscosity.py:19,139-142 — including the historical
"Boltzman_constant" misspelling kept for compatibility (MDAnalysis
Issue #4213; reference tests rely on the fallback at
test_viscosity.py:99-103).
"""

# Boltzmann constant in kJ/(mol·K): R = N_A * k_B = 8.314462159 J/(mol·K)
BOLTZMANN_KJ_PER_MOL_K = 8.314462159e-3

constants = {
    "N_Avogadro": 6.02214076e23,  # mol**-1
    "elementary_charge": 1.602176634e-19,  # C
    "calorie": 4.184,  # J
    "Boltzmann_constant": BOLTZMANN_KJ_PER_MOL_K,  # kJ/(mol·K)
    "Boltzman_constant": BOLTZMANN_KJ_PER_MOL_K,  # historical typo alias
    "electric_constant": 5.526350e-3,  # As/(Vm)
}
