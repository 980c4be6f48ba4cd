"""Offline location-name -> continent-code table.

The reference resolves the label destinations of the three ``*/continent``
pseudo-relations through the geonames web service (``get_continent``,
data/fb15k-237/data_processing.py:19-26) with two hard-coded overrides
(:105-108). Without network access the lookup is a static table keyed by
the FB15k entity *name* (``FB15k_mid2name.txt`` spelling, underscores).
Codes follow geonames' continent field: EU AS SA NA AF OC (NA covers
Central America and the Caribbean, as geonames does). Unknown names
resolve to ``None``, the reference's result when geocoding fails (label id
6, data_processing.py:91). The same table as the JAX package's.

Lookups normalize underscores and case, so both ``United_Kingdom`` and
``united kingdom`` hit. Callers may overlay their own entries through the
``extra`` argument of :func:`continent_of`.
"""

from __future__ import annotations

from typing import Dict, Optional

_COUNTRIES: Dict[str, str] = {
    # Europe
    "Albania": "EU", "Andorra": "EU", "Austria": "EU", "Belarus": "EU",
    "Belgium": "EU", "Bosnia_and_Herzegovina": "EU", "Bulgaria": "EU",
    "Croatia": "EU", "Cyprus": "EU", "Czech_Republic": "EU", "Denmark": "EU",
    "Estonia": "EU", "Finland": "EU", "France": "EU", "Germany": "EU",
    "Greece": "EU", "Hungary": "EU", "Iceland": "EU", "Ireland": "EU",
    "Republic_of_Ireland": "EU", "Italy": "EU", "Latvia": "EU",
    "Liechtenstein": "EU", "Lithuania": "EU", "Luxembourg": "EU",
    "Malta": "EU", "Moldova": "EU", "Monaco": "EU", "Montenegro": "EU",
    "Netherlands": "EU", "North_Macedonia": "EU", "Norway": "EU",
    "Poland": "EU", "Portugal": "EU", "Romania": "EU", "Russia": "EU",
    "San_Marino": "EU", "Serbia": "EU", "Slovakia": "EU", "Slovenia": "EU",
    "Spain": "EU", "Sweden": "EU", "Switzerland": "EU", "Ukraine": "EU",
    "United_Kingdom": "EU", "Vatican_City": "EU", "England": "EU",
    "Scotland": "EU", "Wales": "EU", "Northern_Ireland": "EU",
    "Great_Britain": "EU", "Kingdom_of_Great_Britain": "EU",
    "Soviet_Union": "EU", "Yugoslavia": "EU", "Czechoslovakia": "EU",
    "East_Germany": "EU", "West_Germany": "EU", "Serbia_and_Montenegro": "EU",
    "Kingdom_of_Prussia": "EU", "Austria-Hungary": "EU",
    "Russian_Empire": "EU", "Ottoman_Empire": "AS", "Gibraltar": "EU",
    "Faroe_Islands": "EU", "Isle_of_Man": "EU", "Jersey": "EU",
    "Guernsey": "EU", "Kosovo": "EU", "Aland_Islands": "EU",
    # Asia
    "Afghanistan": "AS", "Armenia": "AS", "Azerbaijan": "AS", "Bahrain": "AS",
    "Bangladesh": "AS", "Bhutan": "AS", "Brunei": "AS", "Cambodia": "AS",
    "China": "AS", "People's_Republic_of_China": "AS", "Georgia": "AS",
    "Hong_Kong": "AS", "India": "AS", "Indonesia": "AS", "Iran": "AS",
    "Iraq": "AS", "Israel": "AS", "Japan": "AS", "Jordan": "AS",
    "Kazakhstan": "AS", "Kuwait": "AS", "Kyrgyzstan": "AS", "Laos": "AS",
    "Lebanon": "AS", "Macau": "AS", "Malaysia": "AS", "Maldives": "AS",
    "Mongolia": "AS", "Myanmar": "AS", "Burma": "AS", "Nepal": "AS",
    "North_Korea": "AS", "Oman": "AS", "Pakistan": "AS", "Palestine": "AS",
    "Philippines": "AS", "Qatar": "AS", "Saudi_Arabia": "AS",
    "Singapore": "AS", "South_Korea": "AS", "Korea": "AS", "Sri_Lanka": "AS",
    "Syria": "AS", "Taiwan": "AS", "Tajikistan": "AS", "Thailand": "AS",
    "Timor-Leste": "AS", "East_Timor": "AS", "Turkey": "AS",
    "Turkmenistan": "AS", "United_Arab_Emirates": "AS", "Uzbekistan": "AS",
    "Vietnam": "AS", "Yemen": "AS", "Tibet": "AS", "British_Raj": "AS",
    # South America
    "Argentina": "SA", "Bolivia": "SA", "Brazil": "SA", "Chile": "SA",
    "Colombia": "SA", "Ecuador": "SA", "Falkland_Islands": "SA",
    "French_Guiana": "SA", "Guyana": "SA", "Paraguay": "SA", "Peru": "SA",
    "Suriname": "SA", "Uruguay": "SA", "Venezuela": "SA",
    # North America (incl. Central America + Caribbean, geonames convention)
    "Antigua_and_Barbuda": "NA", "Bahamas": "NA", "Barbados": "NA",
    "Belize": "NA", "Bermuda": "NA", "Canada": "NA", "Costa_Rica": "NA",
    "Cuba": "NA", "Dominica": "NA", "Dominican_Republic": "NA",
    "El_Salvador": "NA", "Greenland": "NA", "Grenada": "NA",
    "Guatemala": "NA", "Haiti": "NA", "Honduras": "NA", "Jamaica": "NA",
    "Mexico": "NA", "Nicaragua": "NA", "Panama": "NA", "Puerto_Rico": "NA",
    "Saint_Kitts_and_Nevis": "NA", "Saint_Lucia": "NA",
    "Saint_Vincent_and_the_Grenadines": "NA", "Trinidad_and_Tobago": "NA",
    "United_States": "NA", "United_States_of_America": "NA", "USA": "NA",
    "Cayman_Islands": "NA", "Aruba": "NA", "Martinique": "NA",
    "Guadeloupe": "NA",
    # Africa
    "Algeria": "AF", "Angola": "AF", "Benin": "AF", "Botswana": "AF",
    "Burkina_Faso": "AF", "Burundi": "AF", "Cameroon": "AF",
    "Cape_Verde": "AF", "Central_African_Republic": "AF", "Chad": "AF",
    "Comoros": "AF", "Democratic_Republic_of_the_Congo": "AF",
    "Republic_of_the_Congo": "AF", "Ivory_Coast": "AF",
    "Cote_d'Ivoire": "AF", "Djibouti": "AF", "Egypt": "AF",
    "Equatorial_Guinea": "AF", "Eritrea": "AF", "Eswatini": "AF",
    "Swaziland": "AF", "Ethiopia": "AF", "Gabon": "AF", "Gambia": "AF",
    "Ghana": "AF", "Guinea": "AF", "Guinea-Bissau": "AF", "Kenya": "AF",
    "Lesotho": "AF", "Liberia": "AF", "Libya": "AF", "Madagascar": "AF",
    "Malawi": "AF", "Mali": "AF", "Mauritania": "AF", "Mauritius": "AF",
    "Morocco": "AF", "Mozambique": "AF", "Namibia": "AF", "Niger": "AF",
    "Nigeria": "AF", "Rwanda": "AF", "Sao_Tome_and_Principe": "AF",
    "Senegal": "AF", "Seychelles": "AF", "Sierra_Leone": "AF",
    "Somalia": "AF", "South_Africa": "AF", "South_Sudan": "AF",
    "Sudan": "AF", "Tanzania": "AF", "Togo": "AF", "Tunisia": "AF",
    "Uganda": "AF", "Zambia": "AF", "Zimbabwe": "AF", "Rhodesia": "AF",
    # Oceania
    "Australia": "OC", "Fiji": "OC", "Kiribati": "OC",
    "Marshall_Islands": "OC", "Micronesia": "OC", "Nauru": "OC",
    "New_Zealand": "OC", "Palau": "OC", "Papua_New_Guinea": "OC",
    "Samoa": "OC", "American_Samoa": "OC", "Solomon_Islands": "OC",
    "Tonga": "OC", "Tuvalu": "OC", "Vanuatu": "OC", "Guam": "OC",
    "New_Caledonia": "OC", "French_Polynesia": "OC", "Tahiti": "OC",
}

_US_STATES = (
    "Alabama Alaska Arizona Arkansas California Colorado Connecticut "
    "Delaware Florida Hawaii Idaho Illinois Indiana Iowa Kansas Kentucky "
    "Louisiana Maine Maryland Massachusetts Michigan Minnesota Mississippi "
    "Missouri Montana Nebraska Nevada New_Hampshire New_Jersey New_Mexico "
    "New_York North_Carolina North_Dakota Ohio Oklahoma Oregon Pennsylvania "
    "Rhode_Island South_Carolina South_Dakota Tennessee Texas Utah Vermont "
    "Virginia Washington West_Virginia Wisconsin Wyoming "
    "Washington,_D.C. District_of_Columbia"
).split()
# note: the US state "Georgia" is intentionally absent — bare "Georgia"
# resolves to the country (AS), matching geonames' search ranking

NAME_TO_CONTINENT: Dict[str, str] = dict(_COUNTRIES)
NAME_TO_CONTINENT.update({s: "NA" for s in _US_STATES})

_NORMALIZED = {
    k.replace("_", " ").lower(): v for k, v in NAME_TO_CONTINENT.items()
}


def continent_of(
    name: str, extra: Optional[Dict[str, str]] = None
) -> Optional[str]:
    """Offline ``get_continent`` (data_processing.py:19-26) with the
    reference's hard-coded overrides (:105-108) applied FIRST. Returns a
    2-letter code or None for unknown locations (-> label id 6)."""
    if name == "United_States_of_America":
        return "NA"
    if name in ("Republic_of_Macedonia", "Palestinian_National_Authority"):
        return "AS"
    if extra:
        got = extra.get(name) or extra.get(name.replace("_", " ").lower())
        if got:
            return got
    got = NAME_TO_CONTINENT.get(name)
    if got:
        return got
    return _NORMALIZED.get(name.replace("_", " ").lower())
