"""Ampyx AP2 aircraft data pack.

Published aircraft data (geometry, polynomial stability-derivative tables in
alpha, aero validity limits, battery model) for the Ampyx AP2 reference
aircraft; see Malz et al., "A reference model for airborne wind energy systems
for optimization and control", Renewable Energy 2019, and Licitra et al. 2017.
Numbers match the reference data pack awebox opts/kite_data/
ampyx_data.py:28-237 so that solutions are comparable.

The stab_derivs table format: ``stab_derivs[Ccoeff][input] = [c0, c1, c2]``
meaning the contribution ``(c0 + c1*alpha + c2*alpha^2) * input`` to Ccoeff,
with the frame of force/moment coefficients declared in
``stab_derivs['frame']``.
"""
import numpy as np


def data_dict():
    d = {}
    d['name'] = 'ampyx'
    d['geometry'] = geometry()
    stab_derivs, aero_validity = aero()
    d['stab_derivs'] = stab_derivs
    d['aero_validity'] = aero_validity
    coeff_min = np.array([0, -80 * np.pi / 180.0])
    coeff_max = np.array([2, 80 * np.pi / 180.0])
    d['battery'] = battery_model_parameters(coeff_max, coeff_min)
    return d


def geometry():
    g = {}
    g['b_ref'] = 5.5          # wing span [m]
    g['s_ref'] = 3.           # planform area [m^2]
    g['c_ref'] = g['s_ref'] / g['b_ref']
    g['m_k'] = 36.8           # mass [kg]
    g['ar'] = g['b_ref'] / g['c_ref']
    g['j'] = np.array([[25., 0.0, 0.47],
                       [0.0, 32., 0.0],
                       [0.47, 0.0, 56.]])
    g['length'] = g['b_ref']
    g['height'] = g['b_ref'] / 5.
    g['delta_max'] = np.array([5., 10., 5.]) * np.pi / 180.
    g['ddelta_max'] = np.array([2., 2., 2.])
    g['c_root'] = 1.4 * g['c_ref']
    g['c_tip'] = 2. * g['c_ref'] - g['c_root']
    g['fuselage'] = True
    g['wing'] = True
    g['tail'] = True
    g['wing_profile'] = None
    g['r_tether'] = np.zeros((3, 1))
    return g


def battery_model_parameters(coeff_max, coeff_min):
    b = {}
    b['flap_length'] = 0.2
    b['flap_width'] = 0.1
    b['max_flap_defl'] = 20. * (np.pi / 180.)
    b['min_flap_defl'] = -20. * (np.pi / 180.)
    b['c_dl'] = (b['max_flap_defl'] - b['min_flap_defl']) / (coeff_min[0] - coeff_max[0])
    b['c_dphi'] = (b['max_flap_defl'] - b['min_flap_defl']) / (coeff_min[1] - coeff_max[1])
    b['defl_lift_0'] = b['min_flap_defl'] - b['c_dl'] * coeff_max[0]
    b['defl_roll_0'] = b['min_flap_defl'] - b['c_dphi'] * coeff_max[1]
    b['voltage'] = 3.7
    b['mAh'] = 5000.
    b['charge'] = b['mAh'] * 3600. * 1e-3
    b['number_of_cells'] = 15.
    b['conversion_efficiency'] = 0.7
    b['power_controller'] = 50.
    b['power_electronics'] = 10.
    b['charge_fraction'] = 1.
    return b


def aero():
    stab_derivs = {}
    stab_derivs['frame'] = {'force': 'control', 'moment': 'control'}

    stab_derivs['CX'] = {
        '0': [-0.0293],
        'alpha': [0.4784, 2.5549],
        'q': [-0.6029, 4.4124],
        'deltae': [-0.0106, 0.1115],
    }
    stab_derivs['CY'] = {
        'beta': [-0.1855, -0.0299, 0.0936],
        'p': [-0.1022, -0.0140, 0.0496],
        'r': [0.1694, 0.1368],
        'deltaa': [-0.0514, -0.0024, 0.0579],
        'deltar': [0.10325, 0.0268, -0.1036],
    }
    stab_derivs['CZ'] = {
        '0': [-0.5526],
        'alpha': [-5.0676, 5.7736],
        'q': [-7.5560, 0.1251, 6.1486],
        'deltae': [-0.315, -0.0013, 0.2923],
    }
    stab_derivs['Cl'] = {
        'beta': [-0.0630, -0.0003, 0.0312],
        'p': [-0.5632, -0.0247, 0.2813],
        'r': [0.1811, 0.6448],
        'deltaa': [-0.2489, -0.0087, 0.2383],
        'deltar': [0.00436, -0.0013],
    }
    stab_derivs['Cm'] = {
        '0': [-0.0307],
        'alpha': [-0.6027],
        'q': [-11.3022, -0.0026, 5.2885],
        'deltae': [-1.0427, -0.0061, 0.9974],
    }
    stab_derivs['Cn'] = {
        'beta': [0.0577, -0.0849],
        'p': [-0.0565, -0.9137],
        'r': [-0.0553, 0.0290, 0.0257],
        'deltaa': [0.01903, -0.1147],
        'deltar': [-0.0404, -0.0117, 0.04089],
    }

    aero_validity = {
        'alpha_max_deg': 9.,
        'alpha_min_deg': -6.,
        'beta_max_deg': 20.,
        'beta_min_deg': -20.,
    }
    return stab_derivs, aero_validity
